// FlashAttention forward for Hopper (sm_90a), fp32 accumulate.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:107
// `flash_attention` / `_flash_kernel` (:60).  What it computes is the same:
// online softmax over KV tiles with the running max m, the running sum l and
// the output accumulator kept in fp32, the causal / sliding-window mask with
// NEG_INF = -1e30 applied after the tanh softcap, dead tiles skipped as
// `_block_live` does, out = acc / max(l, 1e-30) in q's dtype and
// lse = m + log(max(l, 1e-30)) in fp32 (the backward of the training slice
// reads it).
//
// Translation.  On the TPU the KV tiles are a sequential grid axis whose
// steps carry (m, l, acc) in VMEM scratch.  Here one thread block owns one
// (batch, head, 64-row q tile) and walks the live KV tiles in a loop, so the
// carry lives in registers.  GQA: query head h reads KV head h / (H / KV)
// by index; K and V are never repeated.  q, k, v and out are read and
// written through their (batch, head, seq) strides with the head dim
// contiguous, so (B, S, H, Dh) activations are taken in place.
//
// Bound.  At the prefill shape (1, 32, 1024, 128) bf16 causal the work is
// ~8.6 GFLOP against ~33 MB of q/k/v/out/lse: 8.7 us of bf16 tensor-core
// time against 10.1 us of HBM traffic on an H100, so bytes bound it by a
// little.  Two kernels, chosen by dtype:
//
// * bf16 (the serving path): tensor cores through mma.sync m16n8k16 with
//   fp32 accumulation, P rounded to bf16 for the PV product (see
//   flash_fwd_mma_kernel).  No TMA, no wgmma and no load/compute overlap
//   inside a block yet: blocks in flight on an SM hide each other's loads.
// * fp32 (parity runs): CUDA-core fp32 products from shared memory
//   (flash_fwd_kernel below), sized so three blocks fit on an SM
//   (73 KB of shared memory each at Dh = 128).  Its layout inside a block
//   (256 threads as 16 x 16):
//     scores  S (64 x 32): thread (ty, tx) owns rows ty + 16 i, cols tx + 16 j
//     softmax           : row tid / 4, four threads per row (shuffle reduce)
//     output  O (64 x D): thread (ty, tx) owns rows ty + 16 i, cols tx + 16 j
//   Shared-memory rows are padded by one float so column walks hit distinct
//   banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;   // q rows per block
constexpr int BK = 32;   // kv rows per tile
constexpr int NT = 256;  // threads per block

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + BQ);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int64_t qsb, int64_t qsh,
                 int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
                 int64_t vsb, int64_t vsh, int64_t vss, int64_t osb,
                 int64_t osh, int64_t oss, int H, int KV, int Sq, int Skv,
                 int causal, int window, float softcap, float scale) {
  constexpr int DP = D + 1;
  constexpr int BKP = BK + 1;
  constexpr int RPT = BQ / 16;  // score / output rows per thread
  constexpr int CPT = BK / 16;  // score cols per thread
  constexpr int DPT = D / 16;   // output cols per thread
  constexpr int SPR = BK / 4;   // softmax cols per thread

  extern __shared__ float smem[];
  float* Qs = smem;              // BQ x DP
  float* Ks = Qs + BQ * DP;      // BK x DP
  float* Vs = Ks + BK * DP;      // BK x DP
  float* Ss = Vs + BK * DP;      // BQ x BKP
  float* row_s = Ss + BQ * BKP;  // BQ: per-row correction, then l

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D;
    const int qi = q0 + r;
    Qs[r * DP + c] = qi < Sq ? qb[(int64_t)qi * qss + c] : 0.f;
  }

  const int srow = tid / 4, spart = tid % 4;
  float m_row = kNegInf, l_row = 0.f;
  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  // live KV tiles only (`_block_live`): causal stops at the diagonal, a
  // window starts at the first tile whose newest key is inside it
  int j_lo = 0, j_hi = (Skv + BK - 1) / BK;
  if (causal) j_hi = min(j_hi, (q0 + BQ - 1) / BK + 1);
  if (window) {
    const int t = q0 - window + 1;
    if (t > 0) j_lo = t / BK;
  }

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's Ks / Vs / Ss are consumed
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e % D;
      const int ki = k0 + r;
      const bool ok = ki < Skv;
      Ks[r * DP + c] = ok ? kb[(int64_t)ki * kss + c] : 0.f;
      Vs[r * DP + c] = ok ? vb[(int64_t)ki * vss + c] : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = Ks[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int r = ty + 16 * i, col = tx + 16 * c;
        const int qi = q0 + r, ki = k0 + col;
        float x = s[i][c] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool keep = ki < Skv;
        if (causal) keep = keep && ki <= qi;
        if (window) keep = keep && ki > qi - window;
        Ss[r * BKP + col] = keep ? x : kNegInf;
      }
    }
    __syncthreads();

    // online softmax of row `srow`, four threads per row
    float* srow_p = Ss + srow * BKP + spart * SPR;
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < SPR; ++c) mx = fmaxf(mx, srow_p[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_row, mx);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < SPR; ++c) {
      const float p = expf(srow_p[c] - m_new);
      srow_p[c] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = expf(m_row - m_new);
    l_row = l_row * corr + psum;
    m_row = m_new;
    if (spart == 0) row_s[srow] = corr;
    __syncthreads();

    // O = O * corr + P V
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float cr = row_s[ty + 16 * i];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) acc[i][dd] *= cr;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ss[(ty + 16 * i) * BKP + c];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        const float vv = Vs[c * DP + tx + 16 * dd];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][dd] = fmaf(pv[i], vv, acc[i][dd]);
      }
    }
  }

  __syncthreads();  // row_s is reused for l
  if (spart == 0) {
    const float l = fmaxf(l_row, 1e-30f);
    row_s[srow] = l;
    const int qi = q0 + srow;
    if (qi < Sq) lse[(int64_t)bh * Sq + qi] = m_row + logf(l);
  }
  __syncthreads();
  float* ob = out + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    if (qi >= Sq) continue;
    const float l = row_s[r];
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
      ob[(int64_t)qi * oss + tx + 16 * dd] = acc[i][dd] / l;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core version (mma.sync m16n8k16, fp32 accumulate)
//
// One block of 4 warps owns a 64-row q tile; warp w owns rows 16 w .. +15.
// Q's fragments stay in registers for the whole KV walk.  Per 64-key tile,
// K is staged row-major and V transposed in shared memory (rows padded by 8
// bf16 so fragment loads hit distinct banks), S = Q K^T is accumulated in
// fp32 fragments, masked and soft-capped in place, the online softmax runs
// on the fragments (a row lives in the 4 lanes of a quad), and P, rounded to
// bf16, is fed straight back as the A operand of O += P V -- the
// accumulator layout of two adjacent 8-column S tiles is the A layout of one
// 16-deep k-step.  m, l and O stay fp32.  Loads are 16-byte vectors, so the
// wrapper requires 16-byte aligned rows.
// ---------------------------------------------------------------------------

constexpr int MQ = 64;   // q rows per block
constexpr int MK = 64;   // kv rows per tile
constexpr int MT = 128;  // threads per block (4 warps)

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * MQ * (D + 8) + D * (MK + 8));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(MT)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                     int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                     int64_t vss, int64_t osb, int64_t osh, int64_t oss,
                     int H, int KV, int Sq, int Skv, int causal, int window,
                     float softcap, float scale) {
  constexpr int RS = D + 8;        // Q / K smem row stride (bf16)
  constexpr int VS = MK + 8;       // V^T smem row stride
  constexpr int KSTEPS = D / 16;   // k-steps of Q K^T
  constexpr int NS = MK / 8;       // 8-wide column tiles of S
  constexpr int NO = D / 8;        // 8-wide column tiles of O
  constexpr int CH = D / 8;        // 16-byte chunks per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + MQ * RS;
  __nv_bfloat16* Vt = Ks + MK * RS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * MQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int e = tid; e < MQ * CH; e += MT) {
    const int r = e / CH, c = e % CH;
    const int qi = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * RS + c * 8) =
        qi < Sq ? *reinterpret_cast<const uint4*>(qb + (int64_t)qi * qss +
                                                  c * 8)
                : zero;
  }
  __syncthreads();
  uint32_t qf[KSTEPS][4];
  const int wr = warp * 16 + g;  // this lane's first row in the tile
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = ld32(Qs + wr * RS + c);
    qf[kk][1] = ld32(Qs + (wr + 8) * RS + c);
    qf[kk][2] = ld32(Qs + wr * RS + c + 8);
    qf[kk][3] = ld32(Qs + (wr + 8) * RS + c + 8);
  }

  const int row0 = q0 + wr, row1 = row0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int j_lo = 0, j_hi = (Skv + MK - 1) / MK;
  if (causal) j_hi = min(j_hi, (q0 + MQ - 1) / MK + 1);
  if (window) {
    const int t = q0 - window + 1;
    if (t > 0) j_lo = t / MK;
  }

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * MK;
    __syncthreads();  // the previous tile's Ks / Vt are consumed
    for (int e = tid; e < MK * CH; e += MT) {
      const int r = e / CH, c = e % CH;
      const int ki = k0 + r;
      *reinterpret_cast<uint4*>(Ks + r * RS + c * 8) =
          ki < Skv ? *reinterpret_cast<const uint4*>(kb + (int64_t)ki * kss +
                                                     c * 8)
                   : zero;
    }
    for (int e = tid; e < MK * CH; e += MT) {
      // consecutive threads take consecutive keys: the transposed 2-byte
      // stores of a warp land in consecutive banks
      const int r = e % MK, c = e / MK;
      const int ki = k0 + r;
      uint4 raw = ki < Skv ? *reinterpret_cast<const uint4*>(
                                 vb + (int64_t)ki * vss + c * 8)
                           : zero;
      const __nv_bfloat16* el = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c * 8 + i) * VS + r] = el[i];
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (n * 8 + g) * RS + t4 * 2;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        mma_bf16(s[n], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = e < 2 ? row0 : row1;
        const int ki = k0 + n * 8 + t4 * 2 + (e & 1);
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool keep = ki < Skv;
        if (causal) keep = keep && ki <= qi;
        if (window) keep = keep && ki > qi - window;
        s[n][e] = keep ? x : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }

#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vr = Vt + (n * 8 + g) * VS + kk * 16 + t4 * 2;
        mma_bf16(o[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  if (t4 == 0) {
    if (row0 < Sq) lse[(int64_t)bh * Sq + row0] = m0 + logf(lc0);
    if (row1 < Sq) lse[(int64_t)bh * Sq + row1] = m1 + logf(lc1);
  }
  __nv_bfloat16* ob = out + b * osb + h * osh;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + t4 * 2;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row0 * oss + d) =
          __floats2bfloat162_rn(o[n][0] / lc0, o[n][1] / lc0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row1 * oss + d) =
          __floats2bfloat162_rn(o[n][2] / lc1, o[n][3] / lc1);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, const int64_t* st, int B, int H, int KV, int Sq,
               int Skv, int causal, int window, float softcap, float scale,
               cudaStream_t stream) {
  auto kern = flash_fwd_mma_kernel<D>;
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + MQ - 1) / MQ, B * H);
  kern<<<grid, MT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], H, KV, Sq, Skv, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

int launch_mma_d(int D, const void* q, const void* k, const void* v,
                 void* out, float* lse, const int64_t* st, int B, int H,
                 int KV, int Sq, int Skv, int causal, int window,
                 float softcap, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_mma<32>(q, k, v, out, lse, st, B, H, KV, Sq, Skv, causal,
                            window, softcap, scale, stream);
    case 64:
      return launch_mma<64>(q, k, v, out, lse, st, B, H, KV, Sq, Skv, causal,
                            window, softcap, scale, stream);
    case 128:
      return launch_mma<128>(q, k, v, out, lse, st, B, H, KV, Sq, Skv,
                             causal, window, softcap, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, const int64_t* st, int B, int H, int KV, int Sq,
               int Skv, int causal, int window, float softcap, float scale,
               cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], H, KV, Sq, Skv, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

int launch_f32_d(int D, const void* q, const void* k, const void* v,
                 void* out, float* lse, const int64_t* st, int B, int H,
                 int KV, int Sq, int Skv, int causal, int window,
                 float softcap, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_f32<32>(q, k, v, out, lse, st, B, H, KV, Sq, Skv, causal,
                            window, softcap, scale, stream);
    case 64:
      return launch_f32<64>(q, k, v, out, lse, st, B, H, KV, Sq, Skv, causal,
                            window, softcap, scale, stream);
    case 128:
      return launch_f32<128>(q, k, v, out, lse, st, B, H, KV, Sq, Skv,
                             causal, window, softcap, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel,
// rows 16-byte aligned).  strides: 12 int64 values, the (batch, head, seq)
// strides of q, k, v and out in elements (head dim contiguous).  lse is a contiguous (B, H, Sq) float32 buffer.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_fwd(int dtype, int D, const void* q, const void* k,
                         const void* v, void* out, float* lse,
                         const int64_t* strides, int B, int H, int KV, int Sq,
                         int Skv, int causal, int window, float softcap,
                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32_d(D, q, k, v, out, lse, strides, B, H, KV, Sq, Skv,
                        causal, window, softcap, scale, s);
  if (dtype == 1)
    return launch_mma_d(D, q, k, v, out, lse, strides, B, H, KV, Sq, Skv,
                        causal, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
