// FlashAttention-2 backward for Hopper (sm_90a): two kernels, fp32
// accumulate.
//
// Replaces the TPU kernels repro/kernels/flash_attention.py:272
// `flash_attention_bwd` -- `_flash_bwd_dq_kernel` (:166) and
// `_flash_bwd_dkv_kernel` (:204).  What they compute is the same: P is
// recomputed from the forward's lse (logits soft-capped, masked to
// NEG_INF = -1e30, p zeroed outside the causal / sliding-window mask),
// dS = P * (dP - delta) with the softcap chain rule (1 - (capped/cap)^2),
// and
//   dq kernel : dQ  = sum over live KV tiles of dS K * scale
//   dkv kernel: dV  = sum over live q tiles of P^T dO,
//               dK  = sum over live q tiles of dS^T Q * scale.
// delta = rowsum(dO * O) is one torch reduction in the wrapper, as the
// reference leaves it to XLA.
//
// Translation.  The TPU runs the tile loop as a sequential grid axis that
// carries the accumulator in VMEM scratch.  Here one thread block owns a
// (batch, head, q tile) for dq, or a (batch, head, KV tile) for dk/dv, and
// walks the live tiles of the other axis in a loop with its accumulators in
// registers; dead tiles are skipped by the loop bounds (`_block_live`).
// The two passes stay separate, as on the TPU: no block writes another's
// rows, so there are no atomics and the gradients are the same from run to
// run.  q, k, v, dO and the gradients are read and written through their
// (batch, head, seq) strides with the head dim contiguous, so the
// (B, S, H, Dh) activations of the model are taken in place.  Query and KV
// head counts must be equal (the wrapper raises for GQA).
//
// Bound.  At the BERT-large phase-1 shape (64, 16, 128, 64) bf16 the least
// bytes are ~135 MB (q, k, v, o, dO read, dq, dk, dv written) against
// 10 B H S^2 Dh = 10.7 GFLOP of tensor-core work: bytes bound it (40 us vs
// 11 us).  At phase 2 (32, 16, 512, 64) it is 268 MB against 86 GFLOP, and
// operations bound it (87 us).  This first version recomputes S and dP in
// both kernels (6 and 8 B H S^2 Dh FLOPs) and does not overlap loads with
// the products inside a block; blocks in flight on an SM hide each other's
// loads.  Two kernels per pass, chosen by dtype:
//
// * bf16 (the training path): tensor cores through mma.sync m16n8k16 with
//   fp32 accumulation, in the fragment layout of flash_fwd.cu.  P and dS are
//   rounded to bf16 as the A operand of the next product (the accumulator
//   layout of two adjacent 8-column tiles is the A layout of one 16-deep
//   k-step).  Operands that are read as the B operand along the sequence
//   are staged transposed in shared memory (K^T for dQ, Q^T and dO^T for dK
//   and dV), rows padded by 8 bf16 so fragment loads hit distinct banks.
// * fp32 (parity runs): CUDA-core products from shared memory, 256 threads
//   as 16 x 16, rows padded by one float.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// P and dS of one logit: `s` is the raw Q.K product, `dp` the dO.V one.
__device__ __forceinline__ void probs_and_dlogits(
    float s, float dp, float lse, float delta, bool keep, float scale,
    float softcap, float* p_out, float* ds_out) {
  float capped = s * scale;
  if (softcap > 0.f) capped = softcap * tanhf(capped / softcap);
  if (!keep) {
    *p_out = 0.f;
    *ds_out = 0.f;
    return;
  }
  const float p = expf(capped - lse);
  float ds = p * (dp - delta);
  if (softcap > 0.f) {
    const float t = capped / softcap;
    ds *= 1.f - t * t;
  }
  *p_out = p;
  *ds_out = ds;
}

__device__ __forceinline__ bool live(int qi, int ki, int Sq, int Skv,
                                     int causal, int window) {
  bool keep = qi < Sq && ki < Skv;
  if (causal) keep = keep && ki <= qi;
  if (window) keep = keep && ki > qi - window;
  return keep;
}

// live KV tiles [lo, hi) of the q tile starting at q0 (`_block_live`)
__device__ __forceinline__ void kv_range(int q0, int bq, int bk, int Skv,
                                         int causal, int window, int* lo,
                                         int* hi) {
  *lo = 0;
  *hi = (Skv + bk - 1) / bk;
  if (causal) *hi = min(*hi, (q0 + bq - 1) / bk + 1);
  if (window) {
    const int t = q0 - window + 1;
    if (t > 0) *lo = t / bk;
  }
}

// live q tiles [lo, hi) of the KV tile starting at k0
__device__ __forceinline__ void q_range(int k0, int bk, int bq, int Sq,
                                        int causal, int window, int* lo,
                                        int* hi) {
  *lo = causal ? k0 / bq : 0;
  *hi = (Sq + bq - 1) / bq;
  if (window) *hi = min(*hi, (k0 + bk - 2 + window) / bq + 1);
}

struct Strides {
  int64_t b, h, s;
};

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int NT = 256;   // 16 x 16 threads
constexpr int FQ = 64;    // dq kernel: q rows per block
constexpr int FK = 32;    //            keys per tile
constexpr int GK = 64;    // dkv kernel: keys per block
constexpr int GQ = 32;    //             q rows per tile

template <int D>
constexpr size_t dq_f32_smem() {
  return sizeof(float) *
         (2 * FQ * (D + 1) + 2 * FK * (D + 1) + FQ * (FK + 1) + 2 * FQ);
}

template <int D>
constexpr size_t dkv_f32_smem() {
  return sizeof(float) *
         (2 * GK * (D + 1) + 2 * GQ * (D + 1) + 2 * GK * (GQ + 1) + 2 * GQ);
}

template <int D>
__global__ void __launch_bounds__(NT)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, Strides sq_, Strides sk, Strides sv,
              Strides sdo, Strides sdq, int H, int Sq, int Skv, int causal,
              int window, float softcap, float scale) {
  constexpr int DP = D + 1, KP = FK + 1;
  constexpr int RPT = FQ / 16, CPT = FK / 16, DPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // FQ x DP
  float* dOs = Qs + FQ * DP;      // FQ x DP
  float* Ks = dOs + FQ * DP;      // FK x DP
  float* Vs = Ks + FK * DP;       // FK x DP
  float* dSs = Vs + FK * DP;      // FQ x KP
  float* lse_s = dSs + FQ * KP;   // FQ
  float* dl_s = lse_s + FQ;       // FQ

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * FQ, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const float* qb = q + b * sq_.b + h * sq_.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  for (int e = tid; e < FQ * D; e += NT) {
    const int r = e / D, c = e % D, qi = q0 + r;
    Qs[r * DP + c] = qi < Sq ? qb[(int64_t)qi * sq_.s + c] : 0.f;
    dOs[r * DP + c] = qi < Sq ? dob[(int64_t)qi * sdo.s + c] : 0.f;
  }
  for (int r = tid; r < FQ; r += NT) {
    const int qi = q0 + r;
    lse_s[r] = qi < Sq ? lse[(int64_t)bh * Sq + qi] : 0.f;
    dl_s[r] = qi < Sq ? delta[(int64_t)bh * Sq + qi] : 0.f;
  }

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  int j_lo, j_hi;
  kv_range(q0, FQ, FK, Skv, causal, window, &j_lo, &j_hi);
  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * FK;
    __syncthreads();  // the previous tile's Ks / Vs / dSs are consumed
    for (int e = tid; e < FK * D; e += NT) {
      const int r = e / D, c = e % D, ki = k0 + r;
      Ks[r * DP + c] = ki < Skv ? kb[(int64_t)ki * sk.s + c] : 0.f;
      Vs[r * DP + c] = ki < Skv ? vb[(int64_t)ki * sv.s + c] : 0.f;
    }
    __syncthreads();
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = Qs[(ty + 16 * i) * DP + d];
        ov[i] = dOs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        kv[c] = Ks[(tx + 16 * c) * DP + d];
        vv[c] = Vs[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(ov[i], vv[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int r = ty + 16 * i, col = tx + 16 * c;
        float p, ds;
        probs_and_dlogits(s[i][c], dp[i][c], lse_s[r], dl_s[r],
                          live(q0 + r, k0 + col, Sq, Skv, causal, window),
                          scale, softcap, &p, &ds);
        dSs[r * KP + col] = ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < FK; ++c) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = dSs[(ty + 16 * i) * KP + c];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        const float kv = Ks[c * DP + tx + 16 * dd];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][dd] = fmaf(dsv[i], kv, acc[i][dd]);
      }
    }
  }

  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
      dqb[(int64_t)qi * sdq.s + tx + 16 * dd] = acc[i][dd] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, Strides sq_,
               Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
               int H, int Sq, int Skv, int causal, int window, float softcap,
               float scale) {
  constexpr int DP = D + 1, QP = GQ + 1;
  constexpr int RPT = GK / 16, CPT = GQ / 16, DPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;               // GK x DP
  float* Vs = Ks + GK * DP;       // GK x DP
  float* Qs = Vs + GK * DP;       // GQ x DP
  float* dOs = Qs + GQ * DP;      // GQ x DP
  float* Ps = dOs + GQ * DP;      // GK x QP  (P^T)
  float* dSs = Ps + GK * QP;      // GK x QP  (dS^T)
  float* lse_s = dSs + GK * QP;   // GQ
  float* dl_s = lse_s + GQ;       // GQ

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * GK, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const float* qb = q + b * sq_.b + h * sq_.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  for (int e = tid; e < GK * D; e += NT) {
    const int r = e / D, c = e % D, ki = k0 + r;
    Ks[r * DP + c] = ki < Skv ? kb[(int64_t)ki * sk.s + c] : 0.f;
    Vs[r * DP + c] = ki < Skv ? vb[(int64_t)ki * sv.s + c] : 0.f;
  }

  float dka[RPT][DPT], dva[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dka[i][j] = dva[i][j] = 0.f;

  int i_lo, i_hi;
  q_range(k0, GK, GQ, Sq, causal, window, &i_lo, &i_hi);
  for (int it = i_lo; it < i_hi; ++it) {
    const int q0 = it * GQ;
    __syncthreads();  // the previous tile's Qs / dOs / Ps / dSs are consumed
    for (int e = tid; e < GQ * D; e += NT) {
      const int r = e / D, c = e % D, qi = q0 + r;
      Qs[r * DP + c] = qi < Sq ? qb[(int64_t)qi * sq_.s + c] : 0.f;
      dOs[r * DP + c] = qi < Sq ? dob[(int64_t)qi * sdo.s + c] : 0.f;
    }
    for (int r = tid; r < GQ; r += NT) {
      const int qi = q0 + r;
      lse_s[r] = qi < Sq ? lse[(int64_t)bh * Sq + qi] : 0.f;
      dl_s[r] = qi < Sq ? delta[(int64_t)bh * Sq + qi] : 0.f;
    }
    __syncthreads();
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[RPT], vv[RPT], qv[CPT], ov[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        kv[i] = Ks[(ty + 16 * i) * DP + d];
        vv[i] = Vs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        qv[c] = Qs[(tx + 16 * c) * DP + d];
        ov[c] = dOs[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          s[i][c] = fmaf(kv[i], qv[c], s[i][c]);
          dp[i][c] = fmaf(vv[i], ov[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int r = ty + 16 * i, col = tx + 16 * c;
        float p, ds;
        probs_and_dlogits(s[i][c], dp[i][c], lse_s[col], dl_s[col],
                          live(q0 + col, k0 + r, Sq, Skv, causal, window),
                          scale, softcap, &p, &ds);
        Ps[r * QP + col] = p;
        dSs[r * QP + col] = ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < GQ; ++c) {
      float pv[RPT], dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pv[i] = Ps[(ty + 16 * i) * QP + c];
        dsv[i] = dSs[(ty + 16 * i) * QP + c];
      }
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        const float ov = dOs[c * DP + tx + 16 * dd];
        const float qv = Qs[c * DP + tx + 16 * dd];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          dva[i][dd] = fmaf(pv[i], ov, dva[i][dd]);
          dka[i][dd] = fmaf(dsv[i], qv, dka[i][dd]);
        }
      }
    }
  }

  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int ki = k0 + ty + 16 * i;
    if (ki >= Skv) continue;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      dkb[(int64_t)ki * sdk.s + tx + 16 * dd] = dka[i][dd] * scale;
      dvb[(int64_t)ki * sdv.s + tx + 16 * dd] = dva[i][dd];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulate)
// ---------------------------------------------------------------------------

constexpr int MB = 64;   // rows per block (4 warps x 16) and per tile
constexpr int MT = 128;  // threads per block

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16) of rows r0 .. r0 + 15, k-step kk, of a row-major
// shared tile with row stride `rs`
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* base, int rs,
                                       int r0, int kk, int g, int t4) {
  const int c = kk * 16 + t4 * 2;
  a[0] = ld32(base + (r0 + g) * rs + c);
  a[1] = ld32(base + (r0 + g + 8) * rs + c);
  a[2] = ld32(base + (r0 + g) * rs + c + 8);
  a[3] = ld32(base + (r0 + g + 8) * rs + c + 8);
}

// C[n] += A (16 x K, fragments in `a`) x B where B[k][n] = M[n][k] for a
// row-major shared tile M with row stride `rs`: n-tiles 0 .. N-1
template <int N, int KSTEPS>
__device__ __forceinline__ void mma_abt(float (*c)[4], const bf16* A, int ars,
                                        int ar0, const bf16* M, int rs, int g,
                                        int t4) {
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t a[4];
    load_a(a, A, ars, ar0, kk, g, t4);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const bf16* mr = M + (n * 8 + g) * rs + kk * 16 + t4 * 2;
      mma_bf16(c[n], a, ld32(mr), ld32(mr + 8));
    }
  }
}

// acc[n] += X (16 x 64: the accumulator tiles x[0..7], rounded to bf16) x B
// where B[k][n] = Mt[n][k], Mt a transposed shared tile with row stride ts
template <int NO>
__device__ __forceinline__ void mma_xb(float (*acc)[4], float (*x)[4],
                                       const bf16* Mt, int ts, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < MB / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const bf16* mr = Mt + (n * 8 + g) * ts + kk * 16 + t4 * 2;
      mma_bf16(acc[n], a, ld32(mr), ld32(mr + 8));
    }
  }
}

// Stage rows [r0, r0 + MB) of a strided (seq, D) bf16 matrix: row-major into
// `rm` (row stride D + 8) and, when `tr` is given, transposed into `tr`
// (row stride MB + 8).  Rows at or past `n` are zero.
template <int D>
__device__ __forceinline__ void stage(bf16* rm, bf16* tr, const bf16* src,
                                      int64_t ss, int r0, int n, int tid) {
  constexpr int RS = D + 8, TS = MB + 8, CH = D / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < MB * CH; e += MT) {
    // consecutive threads take consecutive rows: the transposed 2-byte
    // stores of a warp land in consecutive banks
    const int r = e % MB, c = e / MB, ri = r0 + r;
    const uint4 raw = ri < n ? *reinterpret_cast<const uint4*>(
                                   src + (int64_t)ri * ss + c * 8)
                             : zero;
    *reinterpret_cast<uint4*>(rm + r * RS + c * 8) = raw;
    if (tr != nullptr) {
      const bf16* el = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(c * 8 + i) * TS + r] = el[i];
    }
  }
}

template <int D>
constexpr size_t dq_mma_smem() {
  // Q, dO, K, V row-major; K transposed
  return sizeof(bf16) * (4 * MB * (D + 8) + D * (MB + 8));
}

template <int D>
constexpr size_t dkv_mma_smem() {
  // K, V, Q, dO row-major; Q, dO transposed; lse and delta
  return sizeof(bf16) * (4 * MB * (D + 8) + 2 * D * (MB + 8)) +
         sizeof(float) * 2 * MB;
}

template <int D>
__global__ void __launch_bounds__(MT)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, Strides sq_, Strides sk, Strides sv,
              Strides sdo, Strides sdq, int H, int Sq, int Skv, int causal,
              int window, float softcap, float scale) {
  constexpr int RS = D + 8, TS = MB + 8, KSTEPS = D / 16;
  constexpr int NS = MB / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + MB * RS;
  bf16* Ks = dOs + MB * RS;
  bf16* Vs = Ks + MB * RS;
  bf16* Kt = Vs + MB * RS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * MB, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  stage<D>(Qs, nullptr, q + b * sq_.b + h * sq_.h, sq_.s, q0, Sq, tid);
  stage<D>(dOs, nullptr, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq, tid);
  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const float lse0 = row0 < Sq ? lse[(int64_t)bh * Sq + row0] : 0.f;
  const float lse1 = row1 < Sq ? lse[(int64_t)bh * Sq + row1] : 0.f;
  const float dl0 = row0 < Sq ? delta[(int64_t)bh * Sq + row0] : 0.f;
  const float dl1 = row1 < Sq ? delta[(int64_t)bh * Sq + row1] : 0.f;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int j_lo, j_hi;
  kv_range(q0, MB, MB, Skv, causal, window, &j_lo, &j_hi);
  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * MB;
    __syncthreads();  // the previous tile's Ks / Vs / Kt are consumed
    stage<D>(Ks, Kt, kb, sk.s, k0, Skv, tid);
    stage<D>(Vs, nullptr, vb, sv.s, k0, Skv, tid);
    __syncthreads();

    float s[NS][4], dp[NS][4];
    mma_abt<NS, KSTEPS>(s, Qs, RS, wr, Ks, RS, g, t4);
    mma_abt<NS, KSTEPS>(dp, dOs, RS, wr, Vs, RS, g, t4);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = e < 2 ? row0 : row1;
        const int ki = k0 + n * 8 + t4 * 2 + (e & 1);
        float p;
        probs_and_dlogits(s[n][e], dp[n][e], e < 2 ? lse0 : lse1,
                          e < 2 ? dl0 : dl1,
                          live(qi, ki, Sq, Skv, causal, window), scale,
                          softcap, &p, &s[n][e]);
      }
    mma_xb<NO>(acc, s, Kt, TS, g, t4);
  }

  bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + t4 * 2;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (int64_t)row0 * sdq.s + d) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (int64_t)row1 * sdq.s + d) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(MT)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq_,
               Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
               int H, int Sq, int Skv, int causal, int window, float softcap,
               float scale) {
  constexpr int RS = D + 8, TS = MB + 8, KSTEPS = D / 16;
  constexpr int NS = MB / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + MB * RS;
  bf16* Qs = Vs + MB * RS;
  bf16* dOs = Qs + MB * RS;
  bf16* Qt = dOs + MB * RS;
  bf16* dOt = Qt + D * TS;
  float* lse_s = reinterpret_cast<float*>(dOt + D * TS);
  float* dl_s = lse_s + MB;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * MB, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const bf16* qb = q + b * sq_.b + h * sq_.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;

  stage<D>(Ks, nullptr, k + b * sk.b + h * sk.h, sk.s, k0, Skv, tid);
  stage<D>(Vs, nullptr, v + b * sv.b + h * sv.h, sv.s, k0, Skv, tid);
  const int wr = warp * 16;
  const int key0 = k0 + wr + g, key1 = key0 + 8;

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  int i_lo, i_hi;
  q_range(k0, MB, MB, Sq, causal, window, &i_lo, &i_hi);
  for (int it = i_lo; it < i_hi; ++it) {
    const int q0 = it * MB;
    __syncthreads();  // the previous tile's Q / dO / lse / delta are consumed
    stage<D>(Qs, Qt, qb, sq_.s, q0, Sq, tid);
    stage<D>(dOs, dOt, dob, sdo.s, q0, Sq, tid);
    for (int r = tid; r < MB; r += MT) {
      const int qi = q0 + r;
      lse_s[r] = qi < Sq ? lse[(int64_t)bh * Sq + qi] : 0.f;
      dl_s[r] = qi < Sq ? delta[(int64_t)bh * Sq + qi] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's 16 keys, columns
    // the tile's 64 queries
    float s[NS][4], dp[NS][4];
    mma_abt<NS, KSTEPS>(s, Ks, RS, wr, Qs, RS, g, t4);
    mma_abt<NS, KSTEPS>(dp, Vs, RS, wr, dOs, RS, g, t4);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + t4 * 2 + (e & 1);
        const int ki = e < 2 ? key0 : key1;
        probs_and_dlogits(s[n][e], dp[n][e], lse_s[col], dl_s[col],
                          live(q0 + col, ki, Sq, Skv, causal, window), scale,
                          softcap, &s[n][e], &dp[n][e]);
      }
    mma_xb<NO>(dva, s, dOt, TS, g, t4);   // dV += P^T dO
    mma_xb<NO>(dka, dp, Qt, TS, g, t4);   // dK += dS^T Q
  }

  bf16* dkb = dk + b * sdk.b + h * sdk.h;
  bf16* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + t4 * 2;
    if (key0 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (int64_t)key0 * sdk.s + d) =
          __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (int64_t)key0 * sdv.s + d) =
          __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    }
    if (key1 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (int64_t)key1 * sdk.s + d) =
          __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (int64_t)key1 * sdv.s + d) =
          __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  Strides s[7];  // q, k, v, dout, then dq (dq pass) or dk, dv (dkv pass)
  int B, H, Sq, Skv, causal, window;
  float softcap, scale;
};

template <typename Kern>
int prepare(Kern kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_dq(int dtype, const Args& a, cudaStream_t st) {
  const int rows = dtype == 0 ? FQ : MB;
  dim3 grid((a.Sq + rows - 1) / rows, a.B * a.H);
  if (dtype == 0) {
    const size_t smem = dq_f32_smem<D>();
    int err = prepare(dq_f32_kernel<D>, smem);
    if (err) return err;
    dq_f32_kernel<D><<<grid, NT, smem, st>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dout, a.lse, a.delta, (float*)a.dq, a.s[0], a.s[1],
        a.s[2], a.s[3], a.s[4], a.H, a.Sq, a.Skv, a.causal, a.window,
        a.softcap, a.scale);
  } else {
    const size_t smem = dq_mma_smem<D>();
    int err = prepare(dq_mma_kernel<D>, smem);
    if (err) return err;
    dq_mma_kernel<D><<<grid, MT, smem, st>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const bf16*)a.dout, a.lse, a.delta, (bf16*)a.dq, a.s[0], a.s[1],
        a.s[2], a.s[3], a.s[4], a.H, a.Sq, a.Skv, a.causal, a.window,
        a.softcap, a.scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(int dtype, const Args& a, cudaStream_t st) {
  const int keys = dtype == 0 ? GK : MB;
  dim3 grid((a.Skv + keys - 1) / keys, a.B * a.H);
  if (dtype == 0) {
    const size_t smem = dkv_f32_smem<D>();
    int err = prepare(dkv_f32_kernel<D>, smem);
    if (err) return err;
    dkv_f32_kernel<D><<<grid, NT, smem, st>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dout, a.lse, a.delta, (float*)a.dk, (float*)a.dv,
        a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.H, a.Sq, a.Skv,
        a.causal, a.window, a.softcap, a.scale);
  } else {
    const size_t smem = dkv_mma_smem<D>();
    int err = prepare(dkv_mma_kernel<D>, smem);
    if (err) return err;
    dkv_mma_kernel<D><<<grid, MT, smem, st>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const bf16*)a.dout, a.lse, a.delta, (bf16*)a.dk, (bf16*)a.dv,
        a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.H, a.Sq, a.Skv,
        a.causal, a.window, a.softcap, a.scale);
  }
  return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int64_t* st,
               int nstrides, int B, int H, int Sq, int Skv, int causal,
               int window, float softcap, float scale) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  for (int i = 0; i < nstrides; ++i)
    a.s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  return a;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores, rows 16-byte
// aligned).  D: 32, 64 or 128.  strides: the (batch, head, seq) strides in
// elements of q, k, v, dout and dq (15 values).  lse and delta are
// contiguous (B, H, Sq) float32.  Returns cudaGetLastError() after the
// launch.
extern "C" int flash_bwd_dq(int dtype, int D, const void* q, const void* k,
                            const void* v, const void* dout, const float* lse,
                            const float* delta, void* dq,
                            const int64_t* strides, int B, int H, int Sq,
                            int Skv, int causal, int window, float softcap,
                            float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, dout, lse, delta, strides, 5, B, H, Sq, Skv,
                     causal, window, softcap, scale);
  a.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_dq<32>(dtype, a, s);
    case 64: return launch_dq<64>(dtype, a, s);
    case 128: return launch_dq<128>(dtype, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As flash_bwd_dq, with the strides of q, k, v, dout, dk and dv (18 values).
extern "C" int flash_bwd_dkv(int dtype, int D, const void* q, const void* k,
                             const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk,
                             void* dv, const int64_t* strides, int B, int H,
                             int Sq, int Skv, int causal, int window,
                             float softcap, float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, dout, lse, delta, strides, 6, B, H, Sq, Skv,
                     causal, window, softcap, scale);
  a.dk = dk;
  a.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_dkv<32>(dtype, a, s);
    case 64: return launch_dkv<64>(dtype, a, s);
    case 128: return launch_dkv<128>(dtype, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
