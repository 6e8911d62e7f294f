// FlashAttention-2 backward for Hopper (sm_90a), fp32 accumulate.
//
// Replaces the TPU kernels repro/kernels/flash_attention.py:272
// `flash_attention_bwd` -- `_flash_bwd_dq_kernel` (:166) and
// `_flash_bwd_dkv_kernel` (:204).  What they compute is the same: P is
// recomputed from the forward's lse (logits soft-capped, masked to
// NEG_INF = -1e30, p zeroed outside the causal / sliding-window mask),
// dS = P * (dP - delta) with the softcap chain rule (1 - (capped/cap)^2),
// delta = rowsum(dO * O), and
//   dQ = sum over live KV tiles of dS K * scale
//   dV = sum over live q tiles of P^T dO,
//   dK = sum over live q tiles of dS^T Q * scale.
//
// Translation.  The TPU runs two passes, each with its tile loop as a
// sequential grid axis that carries the accumulator in VMEM scratch, and
// leaves delta to XLA.  Here the bf16 route (the training path) is three
// launches:
//
// * pre-pass (`bwd_prep_kernel`): delta in fp32 from one read of dO and O,
//   lse2 = lse * log2(e), both with rows padded to whole 64-row tiles, and
//   the fp32 dQ accumulator (B, H, Sq, Dh) zeroed.
// * main pass: one block owns a (batch, head, tile of 128 keys), holds K
//   and V in shared memory and dK, dV in fp32 registers, and streams the
//   live q tiles of Q, dO, lse2 and delta through a ring of shared-memory
//   stages, each loaded asynchronously while earlier tiles' products run.
//   Per q tile, on tensor cores with fp32 accumulation:
//     S^T = K Q^T and dP^T = V dO^T          (once: 4 units of B H S^2 Dh)
//     P, dS in registers, rounded to bf16 as the A operand
//     dV += P^T dO, dK += dS^T Q             (the operand layout reads dO
//                                             and Q transposed, no copy)
//     dS^T staged once to shared memory as bf16, then
//     dQ_tile = dS K added into the fp32 accumulator with
//     red.global.add.v4.f32.
//   That is 10 units of B H S^2 Dh of tensor-core work, the function's own
//   count; the two-kernel version it replaces recomputed S and dP (14).
//   Both stages of the Hopper design landed, chosen by the head dim:
//   - Dh 64 (`bwd_hopper_kernel`, BERT's head; stage b): two warpgroups of
//     64 keys; every product a wgmma reading its shared-memory operands
//     through 128-byte-swizzled descriptors (P^T and dS^T from registers);
//     the tiles arrive by TMA (tensor maps built per call from the strides)
//     and bulk copies into a ring of 3 stages tracked by mbarriers, issued
//     by thread 0 two tiles ahead.  A separate producer warp, the usual
//     shape, made a block of 384 threads, for which ptxas allots 168
//     registers a thread: the consumers spilled and their wgmmas were
//     serialized.  These 256 threads fit in 255 registers without spills.
//   - Dh 32 and 128 (`bwd_fused_kernel`, stage a): 8 warps of 16 keys on
//     mma.sync m16n8k16 with ldmatrix(.trans) fragments and a 2-stage
//     cp.async ring.
//   With one KV tile (Skv <= 128) a block owns its q rows' dQ and writes
//   dq itself: no accumulator, no atomics, no post-pass (the caller passes
//   no accumulator; `flash_bwd` refuses that over more keys).
// * post-pass (`bwd_post_kernel`): dQ = accumulator * scale as bf16 into
//   dq's (B, S, H, Dh) memory.
//
// dQ is summed with atomics, in an order that varies from run to run: the
// bf16 route's dQ is not bit-identical between runs (dK and dV are, as is
// every gradient of the fp32 route).  Operands are read and gradients
// written through their (batch, head, seq) strides with the head dim
// contiguous, so the (B, S, H, Dh) activations of the model are taken in
// place.  Query and KV head counts must be equal (the wrapper raises for
// GQA).
//
// Bound.  At the BERT-large phase-1 shape (64, 16, 128, 64) bf16 the least
// bytes are 134.7 MB (q, k, v, o, dO read, dq, dk, dv written, lse) against
// 10 B H S^2 Dh = 10.7 GFLOP: bytes bound it (40 us vs 11 us).  At phase 2
// (32, 16, 512, 64) it is 269.5 MB against 85.9 GFLOP, and operations bound
// it (87 us).  What holds the Dh-64 kernel back: one block per SM (its
// registers), and per q tile a block-wide barrier before the dQ product
// (it reads all 128 keys' dS^T), so the two warpgroups' exponentials and
// products take turns on the SM more than they overlap; the pre- and
// post-pass move the fp32 accumulator (4 bytes a dQ element, three times).
//
// The fp32 route (parity runs) keeps two CUDA-core kernels, one for dQ and
// one for dK and dV (256 threads as 16 x 16, rows padded by one float),
// after the same pre-pass.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

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

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// pre-pass: delta = rowsum(dO * O) in fp32; zero the dQ accumulator
// ---------------------------------------------------------------------------

constexpr int PT = 256;  // threads per block of the pre- and post-pass

// D / 8 threads per row.  bf16 rows are read as one 16-byte vector a thread;
// fp32 rows element by element (their rows need no alignment).  delta (and
// lse2 = lse * log2(e), when asked for) are written with a row pitch of
// `pitch` per (batch, head); lse is contiguous (B, H, Sq).
template <typename T, int D>
__global__ void __launch_bounds__(PT)
bwd_prep_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                Strides sdo, Strides so, const float* __restrict__ lse,
                float* __restrict__ lse2, float* __restrict__ delta,
                float* __restrict__ dq_acc, int H, int Sq, int pitch,
                int64_t rows) {
  constexpr int TPR = D / 8;
  const int64_t row = ((int64_t)blockIdx.x * PT + threadIdx.x) / TPR;
  const int part = threadIdx.x % TPR;
  const bool valid = row < rows;
  float acc = 0.f;
  if (valid) {
    const int64_t bh = row / Sq;
    const int s = (int)(row % Sq), b = (int)(bh / H), h = (int)(bh % H);
    const T* dr = dout + b * sdo.b + h * sdo.h + s * sdo.s;
    const T* orow = out + b * so.b + h * so.h + s * so.s;
    if constexpr (std::is_same<T, bf16>::value) {
      const uint4 a = *reinterpret_cast<const uint4*>(dr + part * 8);
      const uint4 o = *reinterpret_cast<const uint4*>(orow + part * 8);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(a2[i]);
        const float2 y = __bfloat1622float2(o2[i]);
        acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
      }
    } else {
#pragma unroll
      for (int i = part; i < D; i += TPR) acc = fmaf(dr[i], orow[i], acc);
    }
    if (dq_acc != nullptr) {
      float4* z = reinterpret_cast<float4*>(dq_acc + row * D + part * 8);
      z[0] = z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (valid && part == 0) {
    const int64_t at = row / Sq * pitch + row % Sq;
    delta[at] = acc;
    if (lse2 != nullptr) lse2[at] = lse[row] * kLog2e;
  }
}

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
// bf16: tensor-core building blocks
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or `bytes` < 16: the rest zero-filled) bytes global -> shared
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; thread t gives the address of row t % 8 of
// matrix t / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
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

// Fragment addresses inside a row-major bf16 tile M with row stride `rs`
// (lane = thread in the warp):
//   a_rm : A (16 x 16) of rows r0.., cols k0.. of M            (ldsm_x4)
//   b_nk : B (16 x 16: k x two n-tiles) with B[k][n] = M[n0 + n][k0 + k]
//          -- b0, b1 of n-tile n0, then of n0 + 8               (ldsm_x4)
//   b_kn : B with B[k][n] = M[k0 + k][n0 + n], same order       (ldsm_x4_t)
//   a_km : A with A[m][k] = M[k0 + k][m0 + m]                   (ldsm_x4_t)
__device__ __forceinline__ const bf16* a_rm(const bf16* M, int rs, int r0,
                                            int k0, int lane) {
  return M + (r0 + (lane & 15)) * rs + k0 + ((lane >> 4) << 3);
}
__device__ __forceinline__ const bf16* b_nk(const bf16* M, int rs, int n0,
                                            int k0, int lane) {
  return M + (n0 + (lane & 7) + ((lane >> 4) << 3)) * rs + k0 +
         (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ const bf16* b_kn(const bf16* M, int rs, int k0,
                                            int n0, int lane) {
  return M + (k0 + (lane & 15)) * rs + n0 + ((lane >> 4) << 3);
}
__device__ __forceinline__ const bf16* a_km(const bf16* M, int rs, int k0,
                                            int m0, int lane) {
  return M + (k0 + (lane & 7) + ((lane >> 4) << 3)) * rs + m0 +
         (((lane >> 3) & 1) << 3);
}

// C[n] (16 x 8 each, n < N) = A_w B for A_w rows r0.. of row-major M
// (16 x D) and B[k][n] = T[n][k] for row-major T (N*8 x D): S^T = K Q^T
template <int N, int D>
__device__ __forceinline__ void mma_rows_by_rows(float (*c)[4], const bf16* M,
                                                 int r0, const bf16* T,
                                                 int lane) {
  constexpr int RS = D + 8;
#pragma unroll
  for (int n = 0; n < N; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_rm(M, RS, r0, kk * 16, lane));
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      uint32_t b[4];
      ldsm_x4(b, b_nk(T, RS, n * 8, kk * 16, lane));
      mma_bf16(c[n], a, b[0], b[1]);
      mma_bf16(c[n + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] (16 x 8 each, n < D / 8) += X B, X = the accumulator tiles
// x[0 .. KS*2) rounded to bf16 (16 x 16 KS) and B[k][n] = T[k][n] for a
// row-major shared tile T (16 KS x D): dV += P^T dO, dK += dS^T Q
template <int KS, int D>
__device__ __forceinline__ void mma_regs_by_tile(float (*acc)[4],
                                                 const uint32_t (*x)[2],
                                                 const bf16* T, int lane) {
  constexpr int RS = D + 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t a[4] = {x[2 * kk][0], x[2 * kk][1], x[2 * kk + 1][0],
                           x[2 * kk + 1][1]};
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, b_kn(T, RS, kk * 16, n * 8, lane));
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 main pass at Dh 64: warpgroup products (wgmma) on TMA-loaded tiles
// ---------------------------------------------------------------------------

// the dQ accumulation (both bf16 main passes): 4 fp32 a thread
__device__ __forceinline__ void red_add_v4(float* p, float a, float b,
                                           float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// One thread's part of a dQ tile: frag[4 j + e] is row r0 (+ 8 for
// e >= 2), column c0 + 8 j + 2 t4 (+ 1 for odd e), j < N -- the layout of
// an mma.sync or wgmma accumulator.  With an accumulator it is added, four
// adjacent columns of one row a lane (lanes t4 and t4 ^ 1 swap halves:
// t4 even adds row r0, t4 odd row r0 + 8).  Without one (a single KV tile,
// whose block owns these rows) dq = frag * scale is stored in bf16.
template <int N, int D>
__device__ __forceinline__ void dq_out(const float* frag, float* dq_acc,
                                       bf16* dq, Strides sdq, int b, int h,
                                       int bh, int Sq, int r0, int c0, int t4,
                                       float scale) {
  if (dq_acc == nullptr) {
    bf16* base = dq + b * sdq.b + h * sdq.h + c0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        if (row < Sq)
          *reinterpret_cast<__nv_bfloat162*>(base + (int64_t)row * sdq.s +
                                             8 * j) =
              __floats2bfloat162_rn(frag[4 * j + 2 * half] * scale,
                                    frag[4 * j + 2 * half + 1] * scale);
      }
    return;
  }
  const bool odd = t4 & 1;
  const int row = r0 + (odd ? 8 : 0);
  float* dst = dq_acc + ((int64_t)bh * Sq + row) * D + c0 + (t4 & 2) * 2;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float y0 = __shfl_xor_sync(
        0xffffffffu, odd ? frag[4 * j] : frag[4 * j + 2], 1);
    const float y1 = __shfl_xor_sync(
        0xffffffffu, odd ? frag[4 * j + 1] : frag[4 * j + 3], 1);
    if (row < Sq) {
      if (odd)
        red_add_v4(dst + 8 * j, y0, y1, frag[4 * j + 2], frag[4 * j + 3]);
      else
        red_add_v4(dst + 8 * j, frag[4 * j], frag[4 * j + 1], y0, y1);
    }
  }
}

constexpr int HD = 64;    // head dim: one 128-byte row a key or query
constexpr int HR = 64;    // q rows per streamed tile
constexpr int HC = 128;   // keys per block: two consumer warpgroups of 64
constexpr int HT = 256;   // two warpgroups; thread 0 also issues the loads
constexpr int HS = 3;     // stages of the q-tile ring
// shared memory (bytes from a 1024-aligned base): K and V, two dS^T tiles
// (tile i writes one while the other may still be read for tile i - 1),
// HS stages of (Q, dO, lse2, delta), the mbarriers.  Every bf16 tile has rows
// of 128 bytes in the 128-byte swizzle that TMA writes and wgmma reads.
constexpr int H_TILE_KV = HC * HD * 2;          // 16 KB
constexpr int H_TILE_Q = HR * HD * 2;           // 8 KB
constexpr int H_STAGE = 2 * H_TILE_Q + 1024;    // Q, dO, lse2, delta
constexpr int H_DST = 2 * H_TILE_KV;
constexpr int H_STAGES = 4 * H_TILE_KV;   // K, V, two dS^T buffers
constexpr int H_BARS = H_STAGES + HS * H_STAGE;
constexpr size_t hopper_smem() { return H_BARS + 8 * (1 + HS) + 1024; }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// until the phase of parity `parity` has completed; a wait of ~10 s (a
// lost transfer) traps, so the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) asm volatile("trap;");
  }
}

// a (64 x rows) box at (0, row, h, b) of a (D, S, H, B) tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int row, int h, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(h), "r"(b),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma operand descriptor of a 128-byte-swizzled bf16 tile: K-major (rows
// of the M or N dim, the K dim contiguous: 8-row groups 1024 bytes apart)
// or MN-major (rows of the K dim, M or N contiguous: the same 1024 bytes
// between groups of 8 K rows; M or N never exceeds the 64 of one row here)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A B on a warpgroup, m64 nN k16, bf16 in, fp32 accumulator d (N / 2
// registers a thread; `acc` 0 overwrites).  ss: A and B from shared memory
// through descriptors; rs: A from registers (4 a thread, the mma.sync A
// fragment of each warp's 16 rows).  TA / TB: 1 if that operand is
// MN-major (the M or N dim contiguous), 0 if K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss32(float* d, uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs64(float* d, const uint32_t* a,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, "
      "%38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// One (batch, head, KV tile of 128 keys) per block, Dh 64: two warpgroups
// of 64 keys each; thread 0 also issues the loads.  lse2 = lse * log2(e) and
// delta are (B H, pitch) fp32 with pitch a multiple of 64; dq_acc is the
// contiguous (B, H, Sq, 64) fp32 accumulator, zeroed by the pre-pass, or
// null: then dq is written (see dq_out).
__global__ void __launch_bounds__(HT, 1)
bwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse2,
                  const float* __restrict__ delta, int pitch,
                  float* __restrict__ dq_acc, bf16* __restrict__ dq,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdq,
                  Strides sdk, Strides sdv, int H,
                  int Sq, int Skv, int causal, int window, float softcap,
                  float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t Ks = base, Vs = base + H_TILE_KV, dSt = base + H_DST;
  const uint32_t bar_kv = base + H_BARS;
  auto stage = [&](int st) { return base + H_STAGES + st * H_STAGE; };
  auto full = [&](int st) { return bar_kv + 8 + 8 * st; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * HC, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  int i_lo, i_hi;
  q_range(k0, HC, HR, Sq, causal, window, &i_lo, &i_hi);
  // tile i (from i_lo) lands in stage i % HS and completes phase i / HS of
  // full(i % HS); thread 0 issues it
  auto load_tile = [&](int i) {
    const int st = i % HS, it = i_lo + i;
    const uint32_t s = stage(st);
    mbar_expect_tx(full(st), 2 * H_TILE_Q + 2 * HR * 4);
    tma_load(s, &tq, it * HR, h, b, full(st));
    tma_load(s + H_TILE_Q, &tdo, it * HR, h, b, full(st));
    const int64_t at = (int64_t)bh * pitch + it * HR;
    bulk_load(s + 2 * H_TILE_Q, lse2 + at, HR * 4, full(st));
    bulk_load(s + 2 * H_TILE_Q + HR * 4, delta + at, HR * 4, full(st));
  };
  const int n_tiles = max(i_hi - i_lo, 0);

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < HS; ++st) mbar_init(full(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * H_TILE_KV);
    tma_load(Ks, &tk, k0, h, b, bar_kv);
    tma_load(Vs, &tv, k0, h, b, bar_kv);
    for (int i = 0; i < min(n_tiles, HS - 1); ++i) load_tile(i);
  }
  __syncthreads();

  // warpgroup wg owns keys wg * 64 .. + 63 of the block
  const int wg = warp / 4, g = lane >> 2, t4 = lane & 3;
  const int kr = wg * 64 + (warp % 4) * 16 + g;  // this thread's key rows
  const int key0 = k0 + kr, key1 = key0 + 8;     //   kr and kr + 8
  const float sl2 = scale * kLog2e;
  float dva[32], dka[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dva[i] = dka[i] = 0.f;
  mbar_wait(bar_kv, 0);

  for (int it = i_lo; it < i_hi; ++it) {
    const int i = it - i_lo, st = i % HS, q0 = it * HR;
    const uint32_t Qs = stage(st), dOs = Qs + H_TILE_Q;
    const float* lse_s =
        reinterpret_cast<const float*>(sbase + (Qs - base) + 2 * H_TILE_Q);
    const float* dl_s = lse_s + HR;
    mbar_wait(full(st), (i / HS) & 1);

    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys x 64
    // queries: A (K, V) and B (Q, dO) both K-major; a k-step is 32 bytes
    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss64<0, 0>(s, wg_desc(Ks + wg * 8192 + kk * 32),
                       wg_desc(Qs + kk * 32), kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss64<0, 0>(dp, wg_desc(Vs + wg * 8192 + kk * 32),
                       wg_desc(dOs + kk * 32), kk);
    wg_commit();
    // P and dS: s[4 j + e] is key kr (+ 8 for e >= 2), query 8 j + 2 t4
    // (+ 1 for odd e), as in an mma.sync accumulator of n-tile j.  Inside
    // the mask and without a softcap, P is taken while dP^T still runs.
    const bool full_tile = q0 + HR <= Sq && k0 + HC <= Skv &&
                           (!causal || k0 + HC - 1 <= q0) &&
                           (!window || k0 > q0 + HR - 1 - window);
    const bool plain = full_tile && softcap == 0.f;
    wg_wait<1>();   // S^T is in
    if (plain) {
#pragma unroll
      for (int x = 0; x < 32; ++x)
        s[x] = exp2f(fmaf(s[x], sl2, -lse_s[(x >> 2) * 8 + t4 * 2 + (x & 1)]));
    }
    wg_wait<0>();   // dP^T is in
#pragma unroll
    for (int j = 0; j < HR / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t4 * 2 + (e & 1), x = 4 * j + e;
        const float dl = dl_s[col];
        if (plain) {
          dp[x] = s[x] * (dp[x] - dl);
        } else {
          float capped = s[x] * scale;
          if (softcap > 0.f) capped = softcap * tanhf(capped / softcap);
          const bool keep = full_tile || live(q0 + col, e < 2 ? key0 : key1,
                                              Sq, Skv, causal, window);
          float p = 0.f, ds = 0.f;
          if (keep) {
            p = exp2f(fmaf(capped, kLog2e, -lse_s[col]));
            ds = p * (dp[x] - dl);
            if (softcap > 0.f) {
              const float t = capped / softcap;
              ds *= 1.f - t * t;
            }
          }
          s[x] = p;
          dp[x] = ds;
        }
      }
    // P^T and dS^T as bf16 A fragments: k-step kk covers queries
    // 16 kk .. + 15, the n-tiles 2 kk and 2 kk + 1
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int x = 4 * (2 * kk + r / 2) + 2 * (r % 2);
        pa[kk][r] = pack_bf16(s[x], s[x + 1]);
        da[kk][r] = pack_bf16(dp[x], dp[x + 1]);
      }
    // dS^T (128 keys x 64 queries) into its swizzled tile: 16-byte chunk c
    // of row r sits at chunk c ^ (r % 8).  Stored before the products that
    // read da are issued: a register an in-flight wgmma reads is not read
    // by other instructions, or ptxas waits for the wgmma.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = kr + 8 * (r % 2), col = 16 * kk + 8 * (r / 2) + 2 * t4;
        *reinterpret_cast<uint32_t*>(
            sbase + H_DST + (i & 1) * H_TILE_KV + row * 128 +
            (((col >> 3) ^ (row & 7)) << 4) +
            (col & 7) * 2) = da[kk][r];
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // dV += P^T dO and dK += dS^T Q: B (dO, Q) MN-major, a k-step is 16
    // query rows (2048 bytes)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs64<1>(dva, pa[kk], wg_desc(dOs + kk * 2048), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs64<1>(dka, da[kk], wg_desc(Qs + kk * 2048), 1);
    wg_commit();
    consumers_sync();  // all of dS^T is in; every warpgroup is done with
                       // tile i - 1, whose stage takes tile i + HS - 1
    if (tid == 0 && i + HS - 1 < n_tiles) load_tile(i + HS - 1);

    // dQ_tile (64 x 64) = dS K: warpgroup wg takes columns 32 wg .. + 31.
    // A = dS (rows of dS^T: MN-major), B = K (MN-major); a k-step is 16
    // keys (2048 bytes)
    float dqa[16];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HC / 16; ++kk)
      wgmma_ss32<1, 1>(dqa,
                       wg_desc(dSt + (i & 1) * H_TILE_KV + kk * 2048),
                       wg_desc(Ks + kk * 2048 + wg * 64), kk);
    wg_commit();
    wg_wait<0>();   // and the dV, dK products

    dq_out<4, HD>(dqa, dq_acc, dq, sdq, b, h, bh, Sq,
                  q0 + (warp % 4) * 16 + g, wg * 32, t4, scale);
  }

  bf16* dkb = dk + b * sdk.b + h * sdk.h;
  bf16* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int d = j * 8 + t4 * 2;
    if (key0 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (int64_t)key0 * sdk.s + d) =
          __floats2bfloat162_rn(dka[4 * j] * scale, dka[4 * j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (int64_t)key0 * sdv.s + d) =
          __floats2bfloat162_rn(dva[4 * j], dva[4 * j + 1]);
    }
    if (key1 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (int64_t)key1 * sdk.s + d) =
          __floats2bfloat162_rn(dka[4 * j + 2] * scale,
                                dka[4 * j + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (int64_t)key1 * sdv.s + d) =
          __floats2bfloat162_rn(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// post-pass: dq = accumulator * scale as bf16, in dq's strided layout
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(PT)
bwd_post_kernel(const float* __restrict__ acc, bf16* __restrict__ dq,
                Strides sdq, int H, int Sq, int64_t rows, float scale) {
  constexpr int CH = D / 8;
  const int64_t e = (int64_t)blockIdx.x * PT + threadIdx.x;
  const int64_t row = e / CH;
  if (row >= rows) return;
  const int c = (int)(e % CH);
  const int64_t bh = row / Sq;
  const int s = (int)(row % Sq), b = (int)(bh / H), h = (int)(bh % H);
  const float4* src = reinterpret_cast<const float4*>(acc + row * D + c * 8);
  const float4 x = src[0], y = src[1];
  const float f[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = pack_bf16(f[2 * i] * scale, f[2 * i + 1] * scale);
  *reinterpret_cast<uint4*>(dq + b * sdq.b + h * sdq.h + s * sdq.s + c * 8) =
      make_uint4(o[0], o[1], o[2], o[3]);
}

// ---------------------------------------------------------------------------
// bf16 main pass at Dh 32 and 128: mma.sync m16n8k16, cp.async stages
// ---------------------------------------------------------------------------

constexpr int NW = 8;         // warps per block
constexpr int BC = 16 * NW;   // keys per block: 16 a warp
constexpr int FT = 32 * NW;   // threads per block

// q rows per streamed tile: 32 at Dh 128 keeps dK, dV, S and dP (Dh + 2 BR
// fp32 a thread) within the register file
template <int D>
__host__ __device__ constexpr int tile_rows() {
  return D == 128 ? 32 : 64;
}

template <int D>
constexpr size_t fused_smem() {
  constexpr int BR = tile_rows<D>();
  // K, V and dS^T, then two stages of (Q, dO, lse, delta); bf16 rows padded
  // by 8 elements (16 bytes) so ldmatrix's eight row reads hit distinct banks
  return sizeof(bf16) * (2 * BC * (D + 8) + BC * (BR + 8)) +
         2 * (sizeof(bf16) * 2 * BR * (D + 8) + sizeof(float) * 2 * BR);
}

// One (batch, head, KV tile of BC keys) per block.  lse (here lse * log2 e)
// and delta are (B H, pitch) fp32; dq_acc is the contiguous (B, H, Sq, D)
// fp32 accumulator, zeroed by the pre-pass, or null (see dq_out).
template <int D>
__global__ void __launch_bounds__(FT, 1)
bwd_fused_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, int pitch,
                 float* __restrict__ dq_acc, bf16* __restrict__ dq,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq_,
                 Strides sk, Strides sv, Strides sdo, Strides sdq,
                 Strides sdk, Strides sdv, int H, int Sq, int Skv, int causal,
                 int window,
                 float softcap, float scale) {
  constexpr int BR = tile_rows<D>();
  constexpr int RS = D + 8, PS = BR + 8, CH = D / 8;
  constexpr int NS = BR / 8, NO = D / 8;
  // the dQ product (BR x D) split over the warps: WR row groups of 16,
  // NW / WR column groups of NQ n-tiles
  constexpr int WR = BR / 16, NQ = D / (NW / WR) / 8;
  static_assert(NW % WR == 0 && NQ % 2 == 0 && NQ <= 4, "tiles");
  constexpr int STAGE = 2 * BR * RS + 4 * BR;  // in bf16 units
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BC * RS;
  bf16* dSt = Vs + BC * RS;          // dS^T (BC x BR), bf16
  bf16* stages = dSt + BC * PS;      // Q, dO, lse, delta per stage

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * BC, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const bf16* qb = q + b * sq_.b + h * sq_.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + (int64_t)bh * pitch;
  const float* dl_b = delta + (int64_t)bh * pitch;

  // rows [r0, r0 + n) of a strided (seq, D) matrix into a padded tile;
  // rows at or past `lim` are zero-filled
  auto load_rows = [&](bf16* dst, const bf16* src, int64_t ss, int r0,
                       int n, int lim) {
    for (int e = tid; e < n * CH; e += FT) {
      const int r = e / CH, c = e % CH, ri = r0 + r;
      const bool ok = ri < lim;
      cp_async16(dst + r * RS + c * 8, ok ? src + ri * ss + c * 8 : src,
                 ok ? 16 : 0);
    }
  };
  auto load_q_tile = [&](int it, int st) {
    bf16* Qs = stages + st * STAGE;
    const int q0 = it * BR;
    load_rows(Qs, qb, sq_.s, q0, BR, Sq);
    load_rows(Qs + BR * RS, dob, sdo.s, q0, BR, Sq);
    float* rows = reinterpret_cast<float*>(Qs + 2 * BR * RS);
    if (tid < 2 * BR) {
      const int r = tid % BR, qi = q0 + r;
      const float* src = tid < BR ? lse_b : dl_b;
      cp_async4(rows + tid, qi < Sq ? src + qi : src, qi < Sq ? 4 : 0);
    }
  };

  int i_lo, i_hi;
  q_range(k0, BC, BR, Sq, causal, window, &i_lo, &i_hi);
  load_rows(Ks, k + b * sk.b + h * sk.h, sk.s, k0, BC, Skv);
  load_rows(Vs, v + b * sv.b + h * sv.h, sv.s, k0, BC, Skv);
  if (i_lo < i_hi) load_q_tile(i_lo, 0);
  cp_async_commit();

  const int wr = warp * 16;  // this warp's keys in the block
  const int key0 = k0 + wr + g, key1 = key0 + 8;
  const int qr = (warp % WR) * 16, qc = (warp / WR) * NQ * 8;  // dQ part
  const float sl2 = scale * kLog2e;

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = i_lo; it < i_hi; ++it) {
    const int st = (it - i_lo) & 1, q0 = it * BR;
    if (it + 1 < i_hi) {
      // the other stage was last read before the previous tile's
      // second barrier
      load_q_tile(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile landed; the previous dQ product is done
    const bf16* Qs = stages + st * STAGE;
    const bf16* dOs = Qs + BR * RS;
    const float* lse_s = reinterpret_cast<const float*>(dOs + BR * RS);
    const float* dl_s = lse_s + BR;

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's 16 keys, columns
    // the tile's BR queries
    float s[NS][4], dp[NS][4];
    mma_rows_by_rows<NS, D>(s, Ks, wr, Qs, lane);
    mma_rows_by_rows<NS, D>(dp, Vs, wr, dOs, lane);

    const bool full = q0 + BR <= Sq && k0 + BC <= Skv &&
                      (!causal || k0 + BC - 1 <= q0) &&
                      (!window || k0 > q0 + BR - 1 - window);
    uint32_t pf[NS][2], dsf[NS][2];  // P^T, dS^T as bf16 A fragments
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + t4 * 2 + (e & 1);
        const float l2 = lse_s[col], dl = dl_s[col];
        if (full && softcap == 0.f) {
          p[e] = exp2f(fmaf(s[n][e], sl2, -l2));
          ds[e] = p[e] * (dp[n][e] - dl);
        } else {
          float capped = s[n][e] * scale;
          if (softcap > 0.f) capped = softcap * tanhf(capped / softcap);
          const bool keep =
              full || live(q0 + col, e < 2 ? key0 : key1, Sq, Skv, causal,
                           window);
          p[e] = keep ? exp2f(fmaf(capped, kLog2e, -l2)) : 0.f;
          ds[e] = p[e] * (dp[n][e] - dl);
          if (softcap > 0.f) {
            const float t = capped / softcap;
            ds[e] *= 1.f - t * t;
          }
        }
      }
      pf[n][0] = pack_bf16(p[0], p[1]);
      pf[n][1] = pack_bf16(p[2], p[3]);
      dsf[n][0] = pack_bf16(ds[0], ds[1]);
      dsf[n][1] = pack_bf16(ds[2], ds[3]);
      *reinterpret_cast<uint32_t*>(dSt + (wr + g) * PS + n * 8 + t4 * 2) =
          dsf[n][0];
      *reinterpret_cast<uint32_t*>(dSt + (wr + g + 8) * PS + n * 8 +
                                   t4 * 2) = dsf[n][1];
    }
    mma_regs_by_tile<BR / 16, D>(dva, pf, dOs, lane);   // dV += P^T dO
    mma_regs_by_tile<BR / 16, D>(dka, dsf, Qs, lane);   // dK += dS^T Q
    __syncthreads();  // dS^T complete; this stage's Q, dO are consumed

    // dQ_tile (BR x D) = dS K: this warp's 16 rows x NQ * 8 columns
    float dqa[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
      dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4_t(a, a_km(dSt, PS, kk * 16, qr, lane));
#pragma unroll
      for (int n = 0; n < NQ; n += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, b_kn(Ks, RS, kk * 16, qc + n * 8, lane));
        mma_bf16(dqa[n], a, bb[0], bb[1]);
        mma_bf16(dqa[n + 1], a, bb[2], bb[3]);
      }
    }
    dq_out<NQ, D>(&dqa[0][0], dq_acc, dq, sdq, b, h, bh, Sq, q0 + qr + g, qc,
                  t4, scale);
  }
  cp_async_wait<0>();  // no copy outlives the block (no live q tile)

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
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float *lse2, *delta, *dq_acc;
  void *dq, *dk, *dv;
  Strides s[8];  // q, k, v, out, dout, dq, dk, dv
  int B, H, Sq, Skv, pitch, causal, window;
  float softcap, scale;
};
enum Strided { SQ, SK, SV, SO, SDO, SDQ, SDK, SDV };

template <typename Kern>
int prepare(Kern kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// the (D = 64, S, H, B) tensor map of a strided bf16 (B, H, S, 64) tensor,
// read in boxes of 64 x `rows`, 128-byte swizzled, rows past S zero-filled
int tensor_map(CUtensorMap* map, const void* ptr, Strides st, int B, int H,
               int S, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {HD, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                               (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {HD, (cuuint32_t)rows, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, bytes, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

int encode_maps(Maps* m, const Args& a) {
  int err;
  if ((err = tensor_map(&m->q, a.q, a.s[SQ], a.B, a.H, a.Sq, HR)) ||
      (err = tensor_map(&m->k, a.k, a.s[SK], a.B, a.H, a.Skv, HC)) ||
      (err = tensor_map(&m->v, a.v, a.s[SV], a.B, a.H, a.Skv, HC)) ||
      (err = tensor_map(&m->dout, a.dout, a.s[SDO], a.B, a.H, a.Sq, HR)))
    return err;
  return 0;
}

int launch_hopper(const Maps& m, const Args& a, cudaStream_t st) {
  int err = prepare(bwd_hopper_kernel, hopper_smem());
  if (err) return err;
  dim3 grid((a.Skv + HC - 1) / HC, a.B * a.H);
  bwd_hopper_kernel<<<grid, HT, hopper_smem(), st>>>(
      m.q, m.k, m.v, m.dout, a.lse2, a.delta, a.pitch, a.dq_acc,
      (bf16*)a.dq, (bf16*)a.dk, (bf16*)a.dv, a.s[SDQ], a.s[SDK], a.s[SDV],
      a.H, a.Sq, a.Skv, a.causal, a.window, a.softcap, a.scale);
  return (int)cudaGetLastError();
}

// fp32: the dQ kernel, then the dK/dV kernel; bf16: the fused kernel
template <int D>
int launch_main(int dtype, const Maps& m, const Args& a, cudaStream_t st) {
  if (dtype == 0) {
    dim3 grid_q((a.Sq + FQ - 1) / FQ, a.B * a.H);
    size_t smem = dq_f32_smem<D>();
    int err = prepare(dq_f32_kernel<D>, smem);
    if (err) return err;
    dq_f32_kernel<D><<<grid_q, NT, smem, st>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dout, a.lse, a.delta, (float*)a.dq, a.s[SQ],
        a.s[SK], a.s[SV], a.s[SDO], a.s[SDQ], a.H, a.Sq, a.Skv, a.causal,
        a.window, a.softcap, a.scale);
    if ((err = (int)cudaGetLastError())) return err;
    dim3 grid_k((a.Skv + GK - 1) / GK, a.B * a.H);
    smem = dkv_f32_smem<D>();
    if ((err = prepare(dkv_f32_kernel<D>, smem))) return err;
    dkv_f32_kernel<D><<<grid_k, NT, smem, st>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dout, a.lse, a.delta, (float*)a.dk, (float*)a.dv,
        a.s[SQ], a.s[SK], a.s[SV], a.s[SDO], a.s[SDK], a.s[SDV], a.H, a.Sq,
        a.Skv, a.causal, a.window, a.softcap, a.scale);
  } else if constexpr (D == HD) {
    return launch_hopper(m, a, st);
  } else {
    dim3 grid((a.Skv + BC - 1) / BC, a.B * a.H);
    const size_t smem = fused_smem<D>();
    int err = prepare(bwd_fused_kernel<D>, smem);
    if (err) return err;
    bwd_fused_kernel<D><<<grid, FT, smem, st>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const bf16*)a.dout, a.lse2, a.delta, a.pitch, a.dq_acc,
        (bf16*)a.dq, (bf16*)a.dk, (bf16*)a.dv, a.s[SQ], a.s[SK], a.s[SV],
        a.s[SDO], a.s[SDQ], a.s[SDK], a.s[SDV], a.H, a.Sq, a.Skv, a.causal,
        a.window, a.softcap, a.scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_prep(int dtype, const Args& a, cudaStream_t st) {
  const int64_t rows = (int64_t)a.B * a.H * a.Sq;
  const unsigned blocks = (unsigned)((rows * (D / 8) + PT - 1) / PT);
  if (dtype == 0)
    bwd_prep_kernel<float, D><<<blocks, PT, 0, st>>>(
        (const float*)a.dout, (const float*)a.out, a.s[SDO], a.s[SO], a.lse,
        nullptr, a.delta, nullptr, a.H, a.Sq, a.pitch, rows);
  else
    bwd_prep_kernel<bf16, D><<<blocks, PT, 0, st>>>(
        (const bf16*)a.dout, (const bf16*)a.out, a.s[SDO], a.s[SO], a.lse,
        a.lse2, a.delta, a.dq_acc, a.H, a.Sq, a.pitch, rows);
  return (int)cudaGetLastError();
}

template <int D>
int launch_post(const Args& a, cudaStream_t st) {
  const int64_t rows = (int64_t)a.B * a.H * a.Sq;
  const unsigned blocks = (unsigned)((rows * (D / 8) + PT - 1) / PT);
  bwd_post_kernel<D><<<blocks, PT, 0, st>>>(a.dq_acc, (bf16*)a.dq, a.s[SDQ],
                                            a.H, a.Sq, rows, a.scale);
  return (int)cudaGetLastError();
}

// the launches `parts` asks for, in order; the host work (tensor maps)
// comes before the first, so the kernels follow each other on the stream
template <int D>
int launch(int parts, int dtype, const Args& a, cudaStream_t st) {
  Maps m;
  int err = 0;
  if constexpr (D == HD)
    if ((parts & 2) && dtype == 1 && (err = encode_maps(&m, a))) return err;
  if ((parts & 1) && (err = launch_prep<D>(dtype, a, st))) return err;
  if ((parts & 2) && (err = launch_main<D>(dtype, m, a, st))) return err;
  if (parts & 4) err = launch_post<D>(a, st);
  return err;
}

// keys per block of the bf16 main pass, at every head dim; the wrapper's
// KV_TILE (kernels/flash_attention.py) names it when it decides whether a
// call needs the dQ accumulator
constexpr int KV_TILE = 128;
static_assert(HC == KV_TILE && BC == KV_TILE,
              "both bf16 main passes take KV_TILE keys a block");

}  // namespace

// The backward's launches, chosen by the bits of `parts`: 1 the pre-pass, 2
// the main pass, 4 the post-pass (bf16 only).  dtype: 0 = float32, 1 =
// bfloat16 (rows 16-byte aligned).  D: 32, 64 or 128.  strides: the
// (batch, head, seq) strides in elements of q, k, v, out, dout, dq, dk, dv
// (24 values).  lse is the forward's contiguous (B, H, Sq) fp32; delta and,
// in bf16, lse2 = lse * log2(e) are (B H, pitch) fp32, pitch Sq in fp32 and
// Sq rounded up to a multiple of 64 in bf16; dq_acc (bf16 only) is the
// contiguous (B, H, Sq, D) fp32 dQ accumulator; it may be null when Skv <=
// KV_TILE: then each q row's dQ comes from one block, which writes dq
// itself (no zeroing, no atomics, no post-pass).  A null accumulator over
// more keys, or a post-pass without one, is refused (cudaErrorInvalidValue).
// In fp32 the main pass always writes dq itself and dq_acc must be null.
// Returns the first failing launch's cudaGetLastError().
extern "C" int flash_bwd(int parts, int dtype, int D, const void* q,
                         const void* k, const void* v, const void* out,
                         const void* dout, const float* lse, float* lse2,
                         float* delta, int pitch, void* dq, float* dq_acc,
                         void* dk, void* dv, const int64_t* strides, int B,
                         int H, int Sq, int Skv, int causal, int window,
                         float softcap, float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (dq_acc == nullptr ? (parts & 4) || (dtype == 1 && Skv > KV_TILE)
                        : dtype == 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.dout = dout;
  a.lse = lse;
  a.lse2 = lse2;
  a.delta = delta;
  a.dq_acc = dq_acc;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  for (int i = 0; i < 8; ++i)
    a.s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.pitch = pitch;
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(parts, dtype, a, s);
    case 64: return launch<64>(parts, dtype, a, s);
    case 128: return launch<128>(parts, dtype, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
