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
// (batch, head, q tile) and walks the live KV tiles in a loop, so the carry
// lives in registers.  GQA: query head h reads KV head h / (H / KV) by
// index; K and V are never repeated.  q, k, v and out are read and written
// through their (batch, head, seq) strides with the head dim contiguous, so
// (B, S, H, Dh) activations are taken in place.
//
// Bound.  At the prefill shape (1, 32, 1024, 128) bf16 causal the work is
// ~8.6 GFLOP against ~33 MB of q/k/v/out/lse: 8.7 us of bf16 tensor-core
// time against 10.1 us of HBM traffic on an H100, so bytes bound it by a
// little; BERT's bidirectional shapes (64, 16, 128, 64) and
// (32, 16, 512, 64) are bound by bytes too (20 and 40 us).  Three kernels,
// chosen by (dtype, Dh) in `flash_fwd` below.  The two 16-bit kernels are
// templated on the element type T, bf16 or f16 (the paper's f16 training):
// P is rounded to T as the A operand of P V, everything else is fp32.
//
// * 16-bit at Dh 64 and 128 (serving's prefill, BERT's training; see
//   flash_fwd_hopper_kernel): warpgroup products (wgmma) on tiles that TMA
//   moves between global and 128-byte-swizzled shared memory.  A block owns
//   128 q rows, two consumer warpgroups of 64.  Thread 0 loads Q and the
//   first live KV tiles; the ring holds 3 tiles of 64 keys at Dh 64 (two
//   blocks an SM, at most 128 registers a thread) and 2 of 128 keys at
//   Dh 128 (one block); each stage has an mbarrier that counts its
//   transaction bytes, and the last warp done with a tile refills its stage
//   (a shared counter), so no thread waits to issue a load.  S = Q K^T
//   reads both operands K-major from shared memory; the online softmax runs
//   on the accumulator in registers in the exp2 domain (scale x log2 e
//   folded into one FFMA, ex2.approx), the mask only on tiles that straddle
//   the diagonal, the window's edge or the end of the keys, the softcap a
//   template flag; O += P V takes P, rounded to T, from registers and V
//   MN-major straight from its tile (no transpose).  A row of Dh 128 is 256
//   bytes, twice the swizzle span: every tile is stored as 64-column
//   halves, each read through its own descriptors (k-steps 4-7 of Q K^T,
//   the second n64 product of P V).  The output goes through shared memory
//   (the warpgroup's Q rows) to a TMA store, which clips the rows past Sq.
//   Causal q tiles are launched longest first.  What holds it back at Dh 64
//   (BERT) is not measured directly (no profiler on the card's machine):
//   the exponentials take one special-function op a logit, as many SFU
//   cycles as the tensor cores spend on the tile's two products, and with
//   four warpgroups an SM neither a software-pipelined loop (S of tile i + 1
//   issued beside P V of tile i) nor ping-pong ordering of the two
//   warpgroups' products was faster (PERF.md).
// * 16-bit at Dh 32 (no path uses it): mma.sync m16n8k16 with fp32
//   accumulation, synchronous loads (flash_fwd_mma_kernel).
// * fp32 at every Dh (parity runs): CUDA-core fp32 products from shared
//   memory (flash_fwd_kernel below), sized so three blocks fit on an SM
//   (73 KB of shared memory each at Dh = 128).  Its layout inside a block
//   (256 threads as 16 x 16):
//     scores  S (64 x 32): thread (ty, tx) owns rows ty + 16 i, cols tx + 16 j
//     softmax           : row tid / 4, four threads per row (shuffle reduce)
//     output  O (64 x D): thread (ty, tx) owns rows ty + 16 i, cols tx + 16 j
//   Shared-memory rows are padded by one float so column walks hit distinct
//   banks.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
// 16-bit at Dh 32: tensor-core version (mma.sync m16n8k16, fp32 accumulate)
//
// One block of 4 warps owns a 64-row q tile; warp w owns rows 16 w .. +15.
// Q's fragments stay in registers for the whole KV walk.  Per 64-key tile,
// K is staged row-major and V transposed in shared memory (rows padded by 8
// elements so fragment loads hit distinct banks), S = Q K^T is accumulated
// in fp32 fragments, masked and soft-capped in place, the online softmax
// runs on the fragments (a row lives in the 4 lanes of a quad), and P,
// rounded to T, is fed straight back as the A operand of O += P V -- the
// accumulator layout of two adjacent 8-column S tiles is the A layout of one
// 16-deep k-step.  m, l and O stay fp32.  Loads are 16-byte vectors, so the
// wrapper requires 16-byte aligned rows.
// ---------------------------------------------------------------------------

constexpr int MQ = 64;   // q rows per block
constexpr int MK = 64;   // kv rows per tile
constexpr int MT = 128;  // threads per block (4 warps)

template <int D>
constexpr size_t mma_smem_bytes() {
  return 2 * (2 * MQ * (D + 8) + D * (MK + 8));
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T, int D>
__global__ void __launch_bounds__(MT)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse,
                     int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                     int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                     int64_t vss, int64_t osb, int64_t osh, int64_t oss,
                     int H, int KV, int Sq, int Skv, int causal, int window,
                     float softcap, float scale) {
  constexpr int RS = D + 8;        // Q / K smem row stride (elements)
  constexpr int VS = MK + 8;       // V^T smem row stride
  constexpr int KSTEPS = D / 16;   // k-steps of Q K^T
  constexpr int NS = MK / 8;       // 8-wide column tiles of S
  constexpr int NO = D / 8;        // 8-wide column tiles of O
  constexpr int CH = D / 8;        // 16-byte chunks per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + MQ * RS;
  T* Vt = Ks + MK * RS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * MQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
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
      const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c * 8 + i) * VS + r] = el[i];
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const T* kr = Ks + (n * 8 + g) * RS + t4 * 2;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        mma16<T>(s[n], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
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
      pa[0] = pack<T>(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack<T>(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const T* vr = Vt + (n * 8 + g) * VS + kk * 16 + t4 * 2;
        mma16<T>(o[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  if (t4 == 0) {
    if (row0 < Sq) lse[(int64_t)bh * Sq + row0] = m0 + logf(lc0);
    if (row1 < Sq) lse[(int64_t)bh * Sq + row1] = m1 + logf(lc1);
  }
  T* ob = out + b * osb + h * osh;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + t4 * 2;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row0 * oss + d) =
          pack<T>(o[n][0] / lc0, o[n][1] / lc0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row1 * oss + d) =
          pack<T>(o[n][2] / lc1, o[n][3] / lc1);
  }
}

// ---------------------------------------------------------------------------
// 16-bit at Dh 64 and 128: warpgroup products (wgmma) on TMA-loaded tiles
//
// Warpgroup wg of the block owns q rows q0 + 64 wg .. + 63; thread t of it
// holds rows ra = 16 (warp % 4) + t / 4 and ra + 8 of those, columns
// 8 j + 2 (t % 4) (+ 1) of every 8-wide n-tile j, in each accumulator (the
// wgmma layout, that of mma.sync for each warp's 16 rows).  So a row lives
// in the 4 lanes of a quad, and the S accumulator, packed to T, is the A
// fragment of the P V product as it stands.  The row sum l is kept per lane
// and added across the quad once, at the end.
// ---------------------------------------------------------------------------

constexpr int WQ = 128;  // q rows per block: two consumer warpgroups of 64
constexpr int WT = 256;  // threads per block
constexpr float kLn2 = 0.6931471805599453f;
// the masked logit NEG_INF in the exp2 domain of the running max
constexpr float kNegInf2 = kNegInf * kLog2e;

// 2^x on the special-function unit, subnormal results flushed to 0 (a
// probability below 2^-126 adds nothing to a row sum of at least 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The tiles of one head dim, and the shared memory of a block (bytes from a
// 1024-aligned base): Q, the stages of (K, V), the mbarriers (Q's, then one
// a stage).  Every tile is stored as D / 64 halves of 64 columns, each with
// 128-byte rows in the swizzle TMA writes and wgmma reads.
template <int D>
struct WTile {
  // keys per KV tile and stages of the ring: at Dh 64, 64 keys in 3 stages
  // (65 KB) and at most 128 registers a thread, so that two blocks share
  // an SM; at Dh 128, 128 keys (S = Q K^T one m64n128 product a k-step) in
  // 2 stages (161 KB), one block an SM
  static constexpr int BK = D == 64 ? 64 : 128;
  static constexpr int WS = D == 64 ? 3 : 2;
  static constexpr int HALVES = D / 64;
  static constexpr int Q_HALF = WQ * 128;            // 16 KB
  static constexpr int KV_HALF = BK * 128;
  static constexpr int Q_BYTES = HALVES * Q_HALF;
  static constexpr int KV_BYTES = HALVES * KV_HALF;  // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int BARS = Q_BYTES + WS * STAGE;
  static constexpr size_t SMEM = BARS + 8 * (1 + WS) + 1024;
};

// One (batch, head, tile of WQ q rows) per block.  The grid is
// (B H, q tiles) for causal attention, the longest tiles dispatched first,
// and (q tiles, B H) otherwise, so that the q tiles of one head run side
// by side while its K and V are in L2.  CAP: a tanh softcap is applied.
template <typename T, int D, bool CAP>
__global__ void __launch_bounds__(WT, D == 64 ? 2 : 1)
flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap to,
                        float* __restrict__ lse, int H, int KV, int Sq,
                        int Skv, int causal, int window, float softcap,
                        float scale) {
  using W = WTile<D>;
  constexpr int WK = W::BK, WS = W::WS;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int released[WS];  // warps done with the stage's tile, summed
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t Qs = base, qbar = base + W::BARS;
  auto full = [&](int st) { return qbar + 8 + 8 * st; };
  auto kv_stage = [&](int st) { return base + W::Q_BYTES + st * W::STAGE; };

  const int n_qt = (Sq + WQ - 1) / WQ;
  const int bh = causal ? blockIdx.x : blockIdx.y;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.x) * WQ;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, g = lane >> 2, t4 = lane & 3;

  // live KV tiles of the block (`_block_live`)
  int j_lo = 0, j_hi = (Skv + WK - 1) / WK;
  if (causal) j_hi = min(j_hi, (q0 + WQ - 1) / WK + 1);
  if (window) {
    const int t = q0 - window + 1;
    if (t > 0) j_lo = t / WK;
  }
  const int n_tiles = max(j_hi - j_lo, 0);
  // tile i (from j_lo) lands in stage i % WS and completes phase i / WS of
  // full(i % WS): thread 0 issues the first WS tiles, and the last warp to
  // be done with tile i issues tile i + WS into its stage
  auto load_tile = [&](int i) {
    const int st = i % WS, k0 = (j_lo + i) * WK;
    const uint32_t ks = kv_stage(st);
    mbar_expect_tx(full(st), W::STAGE);
#pragma unroll
    for (int hf = 0; hf < W::HALVES; ++hf) {
      tma_load(ks + hf * W::KV_HALF, &tk, k0, kvh, b, full(st), 64 * hf);
      tma_load(ks + W::KV_BYTES + hf * W::KV_HALF, &tv, k0, kvh, b, full(st),
               64 * hf);
    }
  };

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < WS; ++st) {
      mbar_init(full(st), 1);
      released[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, W::Q_BYTES);
#pragma unroll
    for (int hf = 0; hf < W::HALVES; ++hf)
      tma_load(Qs + hf * W::Q_HALF, &tq, q0, h, b, qbar, 64 * hf);
    for (int i = 0; i < min(n_tiles, WS); ++i) load_tile(i);
  }
  __syncthreads();

  const int r_lo = q0 + 64 * wg;                    // the warpgroup's rows
  const int ra = r_lo + (warp % 4) * 16 + g, rb = ra + 8;  // this thread's
  const uint32_t Qw = Qs + wg * 64 * 128;
  const float sl2 = scale * kLog2e;
  float o[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
  float m0 = kNegInf2, m1 = kNegInf2, l0 = 0.f, l1 = 0.f;
  mbar_wait(qbar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % WS, k0 = (j_lo + i) * WK;
    const uint32_t ks = kv_stage(st), vs = ks + W::KV_BYTES;
    // does any row of this warpgroup see a key of this tile?
    const bool live = r_lo < Sq && (!causal || k0 <= r_lo + 63) &&
                      (!window || k0 + WK - 1 > r_lo - window);
    mbar_wait(full(st), (i / WS) & 1);
    if (live) {
      // S = Q K^T (64 x WK): A (Q) and B (K) K-major, a k-step 32 bytes of
      // a half
      float s[WK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int at = (kk & 3) * 32;
        const uint64_t dq = wg_desc(Qw + (kk >> 2) * W::Q_HALF + at);
        const uint64_t dk = wg_desc(ks + (kk >> 2) * W::KV_HALF + at);
        if constexpr (WK == 128)
          wgmma_ss128<T, 0, 0>(s, dq, dk, kk);
        else
          wgmma_ss64<T, 0, 0>(s, dq, dk, kk);
      }
      wg_commit();
      wg_wait<0>();
      // the mask only where the tile straddles the diagonal, the window's
      // edge or the end of the keys; then (or with a softcap) s holds the
      // logits in the exp2 domain, else the raw products, scaled in the
      // exponent's FFMA
      const bool edge = k0 + WK > Skv || (causal && k0 + WK - 1 > r_lo) ||
                        (window && k0 <= r_lo + 63 - window);
      float mult = sl2;
      if (edge || CAP) {
#pragma unroll
        for (int j = 0; j < WK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = CAP ? softcap * kLog2e * tanhf(s[4 * j + e] *
                                                     (scale / softcap))
                          : s[4 * j + e] * sl2;
            if (edge) {
              const int qi = e < 2 ? ra : rb;
              const int ki = k0 + 8 * j + 2 * t4 + (e & 1);
              bool keep = ki < Skv;
              if (causal) keep = keep && ki <= qi;
              if (window) keep = keep && ki > qi - window;
              x = keep ? x : kNegInf2;
            }
            s[4 * j + e] = x;
          }
        mult = 1.f;
      }
      float mx0 = fmaxf(s[0], s[1]), mx1 = fmaxf(s[2], s[3]);
#pragma unroll
      for (int j = 1; j < WK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0 * mult), mn1 = fmaxf(m1, mx1 * mult);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < WK / 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], mult, -mn0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], mult, -mn0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], mult, -mn1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], mult, -mn1));
        ps0 += s[4 * j] + s[4 * j + 1];
        ps1 += s[4 * j + 2] + s[4 * j + 3];
      }
      const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
      // P as T A fragments: k-step kk covers keys 16 kk .. + 15, the
      // n-tiles 2 kk and 2 kk + 1
      uint32_t pa[WK / 16][4];
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int x = 4 * (2 * kk + r / 2) + 2 * (r % 2);
          pa[kk][r] = pack<T>(s[x], s[x + 1]);
        }
      // O += P V: B (V) MN-major, a k-step 16 keys (2048 bytes) of a half;
      // one n64 product per half of the head dim
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk)
#pragma unroll
        for (int hf = 0; hf < W::HALVES; ++hf)
          wgmma_rs64<T, 1>(o + 32 * hf, pa[kk],
                        wg_desc(vs + hf * W::KV_HALF + kk * 2048), 1);
      wg_commit();
      wg_wait<0>();
    }
    // this warp is done with tile i (its products have completed); the
    // last of the block's warps refills the stage with tile i + WS, while
    // the tiles between are in flight or landed.  Every warp waited for
    // tile i above, so no count of tile i + WS can come before it.
    if (lane == 0 && atomicAdd(&released[st], 1) % (WT / 32) == WT / 32 - 1 &&
        i + WS < n_tiles)
      load_tile(i + WS);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  const float il0 = 1.f / lc0, il1 = 1.f / lc1;
  if (t4 == 0) {
    if (ra < Sq) lse[(int64_t)bh * Sq + ra] = m0 * kLn2 + logf(lc0);
    if (rb < Sq) lse[(int64_t)bh * Sq + rb] = m1 * kLn2 + logf(lc1);
  }
  // out = O / l as T into this warpgroup's Q rows (read by no product
  // any more) in the 128-byte swizzle (16-byte chunk c of row r at chunk
  // c ^ (r % 8)), then one TMA store a half of the head dim; the map clips
  // the rows past Sq
  unsigned char* orow = smem_raw + (Qw - smem_u32(smem_raw)) +
                        ((warp % 4) * 16 + g) * 128 + 4 * t4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    unsigned char* at = orow + (j / 8) * W::Q_HALF + (((j % 8) ^ g) << 4);
    *reinterpret_cast<uint32_t*>(at) =
        pack<T>(o[4 * j] * il0, o[4 * j + 1] * il0);
    *reinterpret_cast<uint32_t*>(at + 8 * 128) =
        pack<T>(o[4 * j + 2] * il1, o[4 * j + 3] * il1);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  if (tid % 128 == 0 && r_lo < Sq) {
#pragma unroll
    for (int hf = 0; hf < W::HALVES; ++hf)
      tma_store(&to, Qw + hf * W::Q_HALF, 64 * hf, r_lo, h, b);
    tma_store_drain();   // the tile is read before the block's memory goes
  }
}

template <typename T, int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, const int64_t* st, int B, int H, int KV, int Sq,
               int Skv, int causal, int window, float softcap, float scale,
               cudaStream_t stream) {
  auto kern = flash_fwd_mma_kernel<T, D>;
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + MQ - 1) / MQ, B * H);
  kern<<<grid, MT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      lse, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], H, KV, Sq, Skv, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool CAP>
int launch_hopper(const CUtensorMap& mq, const CUtensorMap& mk,
                  const CUtensorMap& mv, const CUtensorMap& mo, float* lse,
                  int B, int H, int KV, int Sq, int Skv, int causal,
                  int window, float softcap, float scale,
                  cudaStream_t stream) {
  auto kern = flash_fwd_hopper_kernel<T, D, CAP>;
  const size_t smem = WTile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + WQ - 1) / WQ;
  const dim3 grid = causal ? dim3(B * H, n_qt) : dim3(n_qt, B * H);
  kern<<<grid, WT, smem, stream>>>(mq, mk, mv, mo, lse, H, KV, Sq, Skv,
                                   causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

// 16-bit (T: bf16 or f16): Dh 64 and 128 on the Hopper kernel (its tensor
// maps encoded here, from the strides), Dh 32 on the mma.sync kernel
template <typename T>
int launch_16(int D, const void* q, const void* k, const void* v,
                void* out, float* lse, const int64_t* st, int B, int H,
                int KV, int Sq, int Skv, int causal, int window,
                float softcap, float scale, cudaStream_t stream) {
  if (D == 32)
    return launch_mma<T, 32>(q, k, v, out, lse, st, B, H, KV, Sq, Skv,
                             causal, window, softcap, scale, stream);
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  CUtensorMap mq, mk, mv, mo;
  const int bk = D == 64 ? WTile<64>::BK : WTile<128>::BK;
  int err;
  if ((err = tensor_map<T>(&mq, q, sq, B, H, Sq, WQ, D)) ||
      (err = tensor_map<T>(&mk, k, sk, B, KV, Skv, bk, D)) ||
      (err = tensor_map<T>(&mv, v, sv, B, KV, Skv, bk, D)) ||
      (err = tensor_map<T>(&mo, out, so, B, H, Sq, 64, D)))
    return err;
  const bool cap = softcap > 0.f;
  auto launch = D == 64 ? (cap ? launch_hopper<T, 64, true>
                               : launch_hopper<T, 64, false>)
                        : (cap ? launch_hopper<T, 128, true>
                               : launch_hopper<T, 128, false>);
  return launch(mq, mk, mv, mo, lse, B, H, KV, Sq, Skv, causal, window,
                softcap, scale, stream);
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

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16, 2 = float16 (rows
// 16-byte aligned; the Hopper kernel at Dh 64 and 128, the mma.sync kernel
// at Dh 32).  strides: 12 int64 values, the (batch, head, seq) strides of
// q, k, v and out in elements (head dim contiguous).  lse is a contiguous
// (B, H, Sq) float32 buffer.  Returns the first CUDA error (tensor-map
// encoding, or cudaGetLastError() after the launch).
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
    return launch_16<bf16>(D, q, k, v, out, lse, strides, B, H, KV, Sq, Skv,
                           causal, window, softcap, scale, s);
  if (dtype == 2)
    return launch_16<f16>(D, q, k, v, out, lse, strides, B, H, KV, Sq, Skv,
                          causal, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
