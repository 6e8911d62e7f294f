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
// leaves delta to XLA.  Here the 16-bit route (the training path, bf16 or
// the paper's f16: every kernel is templated on the element type T) is
// three launches:
//
// * pre-pass (`bwd_prep_kernel`): delta in fp32 from one read of dO and O,
//   lse2 = lse * log2(e), both with rows padded to whole 64-row tiles.
// * main pass: one block owns a (batch, head, tile of 128 keys), holds K
//   and V in shared memory and dK, dV in fp32 registers, and streams the
//   live q tiles of Q, dO, lse2 and delta through a ring of shared-memory
//   stages, each loaded asynchronously while earlier tiles' products run.
//   Per q tile, on tensor cores with fp32 accumulation:
//     S^T = K Q^T and dP^T = V dO^T          (once: 4 units of B H S^2 Dh)
//     P, dS in registers, rounded to T as the A operand
//     dV += P^T dO, dK += dS^T Q             (the operand layout reads dO
//                                             and Q transposed, no copy)
//     dS^T staged once to shared memory as T, then
//     dQ_tile = dS K stored as this block's fp32 partial, in its own slice
//     (its KV tile) of a (n KV tiles, B, H, Sq, Dh) buffer.
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
//   dq itself: no partials, no post-pass (the caller passes no partial
//   buffer; `flash_bwd` refuses that over more keys).
// * post-pass (`bwd_post_kernel`): dQ of a q row = the sum of its partials
//   over the KV tiles whose blocks saw its q tile, in tile order, times
//   scale, as T into dq's (B, S, H, Dh) memory.
//
// Determinism.  Every sum has one order: dK and dV are each one block's
// registers, dQ's partials are added by the post-pass in KV-tile order,
// and no floating-point atomic is left, so the 16-bit route is
// bit-identical from run to run, as the fp32 route is.  (The route before
// added dQ with red.global.add.v4.f32, in an order that varied.)  The cost
// is traffic: each main-pass block stores its partial (4 bytes a dQ
// element a KV tile) and the post-pass reads them all, where an atomic
// accumulator moved 4 bytes an element three times: at phase 2 (four KV
// tiles) 268 MB written and read against 67 MB, ~0.06 ms at 3.35 TB/s.
// FlashAttention-3's other deterministic design, adds into one accumulator
// ordered by a per-tile semaphore, keeps 67 MB but makes blocks wait on
// each other.  Operands are read and gradients
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
// post-pass move the fp32 dQ partials (4 bytes a dQ element a KV tile).
//
// The fp32 route (parity runs) keeps two CUDA-core kernels, one for dQ and
// one for dK and dV (256 threads as 16 x 16, rows padded by one float),
// after the same pre-pass.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

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

// live q tiles [lo, hi) of the KV tile starting at k0: exactly the q tiles
// whose live KV tiles (kv_range) hold it, so the post-pass finds a q row's
// dQ partials in the KV tiles whose blocks wrote them
__device__ __forceinline__ void q_range(int k0, int bk, int bq, int Sq,
                                        int causal, int window, int* lo,
                                        int* hi) {
  *lo = causal ? k0 / bq : 0;
  *hi = (Sq + bq - 1) / bq;
  if (window) *hi = min(*hi, (k0 + bk - 2 + window) / bq + 1);
}

// keys per block of the 16-bit main pass, at every head dim; the wrapper's
// KV_TILE (kernels/flash_attention.py) names it when it decides whether a
// call needs the dQ partials
constexpr int KV_TILE = 128;

// q rows per streamed tile of the 16-bit main pass: 32 at Dh 128 keeps the
// mma.sync kernel's dK, dV, S and dP (Dh + 2 BR fp32 a thread) within the
// register file
template <int D>
__host__ __device__ constexpr int tile_rows() {
  return D == 128 ? 32 : 64;
}


// ---------------------------------------------------------------------------
// pre-pass: delta = rowsum(dO * O) in fp32, lse2 = lse * log2(e)
// ---------------------------------------------------------------------------

constexpr int PT = 256;  // threads per block of the pre- and post-pass

// D / 8 threads per row.  16-bit rows are read as one 16-byte vector a
// thread; fp32 rows element by element (their rows need no alignment).
// delta (and lse2 = lse * log2(e), when asked for) are written with a row
// pitch of `pitch` per (batch, head); lse is contiguous (B, H, Sq).
template <typename T, int D>
__global__ void __launch_bounds__(PT)
bwd_prep_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                Strides sdo, Strides so, const float* __restrict__ lse,
                float* __restrict__ lse2, float* __restrict__ delta, int H,
                int Sq, int pitch, int64_t rows) {
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
    if constexpr (!std::is_same<T, float>::value) {
      const uint4 a = *reinterpret_cast<const uint4*>(dr + part * 8);
      const uint4 o = *reinterpret_cast<const uint4*>(orow + part * 8);
      const uint32_t* a2 = reinterpret_cast<const uint32_t*>(&a);
      const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = unpack<T>(a2[i]);
        const float2 y = unpack<T>(o2[i]);
        acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
      }
    } else {
#pragma unroll
      for (int i = part; i < D; i += TPR) acc = fmaf(dr[i], orow[i], acc);
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
// 16-bit: tensor-core building blocks
// ---------------------------------------------------------------------------


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

// four 8 x 8 matrices of 16-bit elements; thread t gives the address of
// row t % 8 of matrix t / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}


// Fragment addresses inside a row-major 16-bit tile M with row stride `rs`
// (lane = thread in the warp):
//   a_rm : A (16 x 16) of rows r0.., cols k0.. of M            (ldsm_x4)
//   b_nk : B (16 x 16: k x two n-tiles) with B[k][n] = M[n0 + n][k0 + k]
//          -- b0, b1 of n-tile n0, then of n0 + 8               (ldsm_x4)
//   b_kn : B with B[k][n] = M[k0 + k][n0 + n], same order       (ldsm_x4_t)
//   a_km : A with A[m][k] = M[k0 + k][m0 + m]                   (ldsm_x4_t)
template <typename T>
__device__ __forceinline__ const T* a_rm(const T* M, int rs, int r0, int k0,
                                         int lane) {
  return M + (r0 + (lane & 15)) * rs + k0 + ((lane >> 4) << 3);
}
template <typename T>
__device__ __forceinline__ const T* b_nk(const T* M, int rs, int n0, int k0,
                                         int lane) {
  return M + (n0 + (lane & 7) + ((lane >> 4) << 3)) * rs + k0 +
         (((lane >> 3) & 1) << 3);
}
template <typename T>
__device__ __forceinline__ const T* b_kn(const T* M, int rs, int k0, int n0,
                                         int lane) {
  return M + (k0 + (lane & 15)) * rs + n0 + ((lane >> 4) << 3);
}
template <typename T>
__device__ __forceinline__ const T* a_km(const T* M, int rs, int k0, int m0,
                                         int lane) {
  return M + (k0 + (lane & 7) + ((lane >> 4) << 3)) * rs + m0 +
         (((lane >> 3) & 1) << 3);
}

// C[n] (16 x 8 each, n < N) = A_w B for A_w rows r0.. of row-major M
// (16 x D) and B[k][n] = Tt[n][k] for row-major Tt (N*8 x D): S^T = K Q^T
template <typename T, int N, int D>
__device__ __forceinline__ void mma_rows_by_rows(float (*c)[4], const T* M,
                                                 int r0, const T* Tt,
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
      ldsm_x4(b, b_nk(Tt, RS, n * 8, kk * 16, lane));
      mma16<T>(c[n], a, b[0], b[1]);
      mma16<T>(c[n + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] (16 x 8 each, n < D / 8) += X B, X = the accumulator tiles
// x[0 .. KS*2) rounded to T (16 x 16 KS) and B[k][n] = Tt[k][n] for a
// row-major shared tile Tt (16 KS x D): dV += P^T dO, dK += dS^T Q
template <typename T, int KS, int D>
__device__ __forceinline__ void mma_regs_by_tile(float (*acc)[4],
                                                 const uint32_t (*x)[2],
                                                 const T* Tt, int lane) {
  constexpr int RS = D + 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t a[4] = {x[2 * kk][0], x[2 * kk][1], x[2 * kk + 1][0],
                           x[2 * kk + 1][1]};
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, b_kn(Tt, RS, kk * 16, n * 8, lane));
      mma16<T>(acc[n], a, b[0], b[1]);
      mma16<T>(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 16-bit main pass at Dh 64: warpgroup products (wgmma) on TMA-loaded tiles
// ---------------------------------------------------------------------------

// One thread's part of a dQ tile: frag[4 j + e] is row r0 (+ 8 for
// e >= 2), column c0 + 8 j + 2 t4 (+ 1 for odd e), j < N -- the layout of
// an mma.sync or wgmma accumulator.  With partials, `part` is this block's
// slice of the (n KV tiles, B, H, Sq, D) fp32 buffer and the tile is stored
// there, four adjacent columns of one row a lane (lanes t4 and t4 ^ 1 swap
// halves: t4 even stores row r0, t4 odd row r0 + 8), for the post-pass to
// add.  Without (a single KV tile, whose block owns these rows) dq =
// frag * scale is stored as T.  Both main passes call it.
template <typename T, int N, int D>
__device__ __forceinline__ void dq_out(const float* frag, float* part, T* dq,
                                       Strides sdq, int b, int h, int bh,
                                       int Sq, int r0, int c0, int t4,
                                       float scale) {
  if (part == nullptr) {
    T* base = dq + b * sdq.b + h * sdq.h + c0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        if (row < Sq)
          *reinterpret_cast<uint32_t*>(base + (int64_t)row * sdq.s + 8 * j) =
              pack<T>(frag[4 * j + 2 * half] * scale,
                      frag[4 * j + 2 * half + 1] * scale);
      }
    return;
  }
  const bool odd = t4 & 1;
  const int row = r0 + (odd ? 8 : 0);
  float* dst = part + ((int64_t)bh * Sq + row) * D + c0 + (t4 & 2) * 2;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float y0 = __shfl_xor_sync(
        0xffffffffu, odd ? frag[4 * j] : frag[4 * j + 2], 1);
    const float y1 = __shfl_xor_sync(
        0xffffffffu, odd ? frag[4 * j + 1] : frag[4 * j + 3], 1);
    if (row < Sq)
      *reinterpret_cast<float4*>(dst + 8 * j) =
          odd ? make_float4(y0, y1, frag[4 * j + 2], frag[4 * j + 3])
              : make_float4(frag[4 * j], frag[4 * j + 1], y0, y1);
  }
}

// this block's slice (its KV tile) of the dQ partials, or null (the block
// writes dq): the grid is (KV tiles, B H) in both main passes
template <int D>
__device__ __forceinline__ float* block_part(float* dq_part, int Sq) {
  return dq_part == nullptr
             ? nullptr
             : dq_part + (int64_t)blockIdx.x * gridDim.y * Sq * D;
}

constexpr int HD = 64;    // head dim: one 128-byte row a key or query
constexpr int HR = 64;    // q rows per streamed tile
constexpr int HC = 128;   // keys per block: two consumer warpgroups of 64
constexpr int HT = 256;   // two warpgroups; thread 0 also issues the loads
constexpr int HS = 3;     // stages of the q-tile ring
// shared memory (bytes from a 1024-aligned base): K and V, two dS^T tiles
// (tile i writes one while the other may still be read for tile i - 1),
// HS stages of (Q, dO, lse2, delta), the mbarriers.  Every T tile has rows
// of 128 bytes in the 128-byte swizzle that TMA writes and wgmma reads.
constexpr int H_TILE_KV = HC * HD * 2;          // 16 KB
constexpr int H_TILE_Q = HR * HD * 2;           // 8 KB
constexpr int H_STAGE = 2 * H_TILE_Q + 1024;    // Q, dO, lse2, delta
constexpr int H_DST = 2 * H_TILE_KV;
constexpr int H_STAGES = 4 * H_TILE_KV;   // K, V, two dS^T buffers
constexpr int H_BARS = H_STAGES + HS * H_STAGE;
constexpr size_t hopper_smem() { return H_BARS + 8 * (1 + HS) + 1024; }

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// One (batch, head, KV tile of 128 keys) per block, Dh 64: two warpgroups
// of 64 keys each; thread 0 also issues the loads.  lse2 = lse * log2(e) and
// delta are (B H, pitch) fp32 with pitch a multiple of 64; dq_part is the
// contiguous (n KV tiles, B, H, Sq, 64) fp32 partial buffer, or null: then
// dq is written (see dq_out).
template <typename T>
__global__ void __launch_bounds__(HT, 1)
bwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse2,
                  const float* __restrict__ delta, int pitch,
                  float* __restrict__ dq_part, T* __restrict__ dq,
                  T* __restrict__ dk, T* __restrict__ dv, Strides sdq,
                  Strides sdk, Strides sdv, int H,
                  int Sq, int Skv, int causal, int window, float softcap,
                  float scale) {
  float* const part = block_part<HD>(dq_part, Sq);
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
      wgmma_ss64<T, 0, 0>(s, wg_desc(Ks + wg * 8192 + kk * 32),
                          wg_desc(Qs + kk * 32), kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss64<T, 0, 0>(dp, wg_desc(Vs + wg * 8192 + kk * 32),
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
    // P^T and dS^T as T A fragments: k-step kk covers queries
    // 16 kk .. + 15, the n-tiles 2 kk and 2 kk + 1
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int x = 4 * (2 * kk + r / 2) + 2 * (r % 2);
        pa[kk][r] = pack<T>(s[x], s[x + 1]);
        da[kk][r] = pack<T>(dp[x], dp[x + 1]);
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
      wgmma_rs64<T, 1>(dva, pa[kk], wg_desc(dOs + kk * 2048), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs64<T, 1>(dka, da[kk], wg_desc(Qs + kk * 2048), 1);
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
      wgmma_ss32<T, 1, 1>(dqa,
                          wg_desc(dSt + (i & 1) * H_TILE_KV + kk * 2048),
                          wg_desc(Ks + kk * 2048 + wg * 64), kk);
    wg_commit();
    wg_wait<0>();   // and the dV, dK products

    dq_out<T, 4, HD>(dqa, part, dq, sdq, b, h, bh, Sq,
                     q0 + (warp % 4) * 16 + g, wg * 32, t4, scale);
  }

  T* dkb = dk + b * sdk.b + h * sdk.h;
  T* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int d = j * 8 + t4 * 2;
    if (key0 < Skv) {
      *reinterpret_cast<uint32_t*>(dkb + (int64_t)key0 * sdk.s + d) =
          pack<T>(dka[4 * j] * scale, dka[4 * j + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (int64_t)key0 * sdv.s + d) =
          pack<T>(dva[4 * j], dva[4 * j + 1]);
    }
    if (key1 < Skv) {
      *reinterpret_cast<uint32_t*>(dkb + (int64_t)key1 * sdk.s + d) =
          pack<T>(dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (int64_t)key1 * sdv.s + d) =
          pack<T>(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// post-pass: dq = the sum of a row's dQ partials in KV-tile order, times
// scale, as T in dq's strided layout
// ---------------------------------------------------------------------------

// f += the 8 floats at p (two 16-byte loads)
__device__ __forceinline__ void add8(float* f, const float* p) {
  const float4 x = reinterpret_cast<const float4*>(p)[0];
  const float4 y = reinterpret_cast<const float4*>(p)[1];
  const float s[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] += s[i];
}

// One thread per 8 columns of a dQ row.  The row's q tile (tile_rows<D>()
// rows, as the main pass streams them) was seen by the blocks of its live
// KV tiles (kv_range), each of which stored its partial in its own slice
// of `part` (n KV tiles, rows = B H Sq, D); they are added in tile order.
template <typename T, int D>
__global__ void __launch_bounds__(PT)
bwd_post_kernel(const float* __restrict__ part, T* __restrict__ dq,
                Strides sdq, int H, int Sq, int Skv, int causal, int window,
                int64_t rows, float scale) {
  constexpr int CH = D / 8, BR = tile_rows<D>();
  const int64_t e = (int64_t)blockIdx.x * PT + threadIdx.x;
  const int64_t row = e / CH;
  if (row >= rows) return;
  const int c = (int)(e % CH);
  const int64_t bh = row / Sq;
  const int s = (int)(row % Sq), b = (int)(bh / H), h = (int)(bh % H);
  int lo, hi;
  kv_range(s / BR * BR, BR, KV_TILE, Skv, causal, window, &lo, &hi);
  float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float* src = part + row * D + c * 8;
  for (int t = lo; t < hi; ++t) add8(f, src + t * rows * D);
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = pack<T>(f[2 * i] * scale, f[2 * i + 1] * scale);
  *reinterpret_cast<uint4*>(dq + b * sdq.b + h * sdq.h + s * sdq.s + c * 8) =
      make_uint4(o[0], o[1], o[2], o[3]);
}

// ---------------------------------------------------------------------------
// 16-bit main pass at Dh 32 and 128: mma.sync m16n8k16, cp.async stages
// ---------------------------------------------------------------------------

constexpr int NW = 8;         // warps per block
constexpr int BC = 16 * NW;   // keys per block: 16 a warp
constexpr int FT = 32 * NW;   // threads per block

template <int D>
constexpr size_t fused_smem() {
  constexpr int BR = tile_rows<D>();
  // K, V and dS^T, then two stages of (Q, dO, lse, delta); 16-bit rows
  // padded by 8 elements (16 bytes) so ldmatrix's eight row reads hit
  // distinct banks
  return 2 * (2 * BC * (D + 8) + BC * (BR + 8)) +
         2 * (2 * 2 * BR * (D + 8) + sizeof(float) * 2 * BR);
}

// One (batch, head, KV tile of BC keys) per block.  lse (here lse * log2 e)
// and delta are (B H, pitch) fp32; dq_part is the contiguous (n KV tiles,
// B, H, Sq, D) fp32 partial buffer, or null (see dq_out).
template <typename T, int D>
__global__ void __launch_bounds__(FT, 1)
bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, int pitch,
                 float* __restrict__ dq_part, T* __restrict__ dq,
                 T* __restrict__ dk, T* __restrict__ dv, Strides sq_,
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
  constexpr int STAGE = 2 * BR * RS + 4 * BR;  // in 16-bit units
  float* const part = block_part<D>(dq_part, Sq);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BC * RS;
  T* dSt = Vs + BC * RS;          // dS^T (BC x BR), T
  T* stages = dSt + BC * PS;      // Q, dO, lse, delta per stage

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * BC, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const T* qb = q + b * sq_.b + h * sq_.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + (int64_t)bh * pitch;
  const float* dl_b = delta + (int64_t)bh * pitch;

  // rows [r0, r0 + n) of a strided (seq, D) matrix into a padded tile;
  // rows at or past `lim` are zero-filled
  auto load_rows = [&](T* dst, const T* src, int64_t ss, int r0,
                       int n, int lim) {
    for (int e = tid; e < n * CH; e += FT) {
      const int r = e / CH, c = e % CH, ri = r0 + r;
      const bool ok = ri < lim;
      cp_async16(dst + r * RS + c * 8, ok ? src + ri * ss + c * 8 : src,
                 ok ? 16 : 0);
    }
  };
  auto load_q_tile = [&](int it, int st) {
    T* Qs = stages + st * STAGE;
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
    const T* Qs = stages + st * STAGE;
    const T* dOs = Qs + BR * RS;
    const float* lse_s = reinterpret_cast<const float*>(dOs + BR * RS);
    const float* dl_s = lse_s + BR;

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's 16 keys, columns
    // the tile's BR queries
    float s[NS][4], dp[NS][4];
    mma_rows_by_rows<T, NS, D>(s, Ks, wr, Qs, lane);
    mma_rows_by_rows<T, NS, D>(dp, Vs, wr, dOs, lane);

    const bool full = q0 + BR <= Sq && k0 + BC <= Skv &&
                      (!causal || k0 + BC - 1 <= q0) &&
                      (!window || k0 > q0 + BR - 1 - window);
    uint32_t pf[NS][2], dsf[NS][2];  // P^T, dS^T as T A fragments
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
      pf[n][0] = pack<T>(p[0], p[1]);
      pf[n][1] = pack<T>(p[2], p[3]);
      dsf[n][0] = pack<T>(ds[0], ds[1]);
      dsf[n][1] = pack<T>(ds[2], ds[3]);
      *reinterpret_cast<uint32_t*>(dSt + (wr + g) * PS + n * 8 + t4 * 2) =
          dsf[n][0];
      *reinterpret_cast<uint32_t*>(dSt + (wr + g + 8) * PS + n * 8 +
                                   t4 * 2) = dsf[n][1];
    }
    mma_regs_by_tile<T, BR / 16, D>(dva, pf, dOs, lane);   // dV += P^T dO
    mma_regs_by_tile<T, BR / 16, D>(dka, dsf, Qs, lane);   // dK += dS^T Q
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
        mma16<T>(dqa[n], a, bb[0], bb[1]);
        mma16<T>(dqa[n + 1], a, bb[2], bb[3]);
      }
    }
    dq_out<T, NQ, D>(&dqa[0][0], part, dq, sdq, b, h, bh, Sq, q0 + qr + g,
                     qc, t4, scale);
  }
  cp_async_wait<0>();  // no copy outlives the block (no live q tile)

  T* dkb = dk + b * sdk.b + h * sdk.h;
  T* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = n * 8 + t4 * 2;
    if (key0 < Skv) {
      *reinterpret_cast<uint32_t*>(dkb + (int64_t)key0 * sdk.s + d) =
          pack<T>(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (int64_t)key0 * sdv.s + d) =
          pack<T>(dva[n][0], dva[n][1]);
    }
    if (key1 < Skv) {
      *reinterpret_cast<uint32_t*>(dkb + (int64_t)key1 * sdk.s + d) =
          pack<T>(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (int64_t)key1 * sdv.s + d) =
          pack<T>(dva[n][2], dva[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float *lse2, *delta, *dq_part;
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


struct Maps {
  CUtensorMap q, k, v, dout;
};

template <typename T>
int encode_maps(Maps* m, const Args& a) {
  int err;
  if ((err = tensor_map<T>(&m->q, a.q, a.s[SQ], a.B, a.H, a.Sq, HR)) ||
      (err = tensor_map<T>(&m->k, a.k, a.s[SK], a.B, a.H, a.Skv, HC)) ||
      (err = tensor_map<T>(&m->v, a.v, a.s[SV], a.B, a.H, a.Skv, HC)) ||
      (err = tensor_map<T>(&m->dout, a.dout, a.s[SDO], a.B, a.H, a.Sq, HR)))
    return err;
  return 0;
}

template <typename T>
int launch_hopper(const Maps& m, const Args& a, cudaStream_t st) {
  int err = prepare(bwd_hopper_kernel<T>, hopper_smem());
  if (err) return err;
  dim3 grid((a.Skv + HC - 1) / HC, a.B * a.H);
  bwd_hopper_kernel<T><<<grid, HT, hopper_smem(), st>>>(
      m.q, m.k, m.v, m.dout, a.lse2, a.delta, a.pitch, a.dq_part, (T*)a.dq,
      (T*)a.dk, (T*)a.dv, a.s[SDQ], a.s[SDK], a.s[SDV], a.H, a.Sq, a.Skv,
      a.causal, a.window, a.softcap, a.scale);
  return (int)cudaGetLastError();
}

// fp32: the dQ kernel, then the dK/dV kernel; 16-bit: the Hopper kernel at
// Dh 64, the fused mma.sync kernel at 32 and 128
template <typename T, int D>
int launch_main(const Maps& m, const Args& a, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
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
    return launch_hopper<T>(m, a, st);
  } else {
    dim3 grid((a.Skv + BC - 1) / BC, a.B * a.H);
    const size_t smem = fused_smem<D>();
    int err = prepare(bwd_fused_kernel<T, D>, smem);
    if (err) return err;
    bwd_fused_kernel<T, D><<<grid, FT, smem, st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        a.lse2, a.delta, a.pitch, a.dq_part, (T*)a.dq, (T*)a.dk, (T*)a.dv,
        a.s[SQ], a.s[SK], a.s[SV], a.s[SDO], a.s[SDQ], a.s[SDK], a.s[SDV],
        a.H, a.Sq, a.Skv, a.causal, a.window, a.softcap, a.scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_prep(const Args& a, cudaStream_t st) {
  const int64_t rows = (int64_t)a.B * a.H * a.Sq;
  const unsigned blocks = (unsigned)((rows * (D / 8) + PT - 1) / PT);
  bwd_prep_kernel<T, D><<<blocks, PT, 0, st>>>(
      (const T*)a.dout, (const T*)a.out, a.s[SDO], a.s[SO], a.lse,
      std::is_same<T, float>::value ? nullptr : a.lse2, a.delta, a.H, a.Sq,
      a.pitch, rows);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_post(const Args& a, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    return (int)cudaErrorInvalidValue;   // fp32 writes dq in the main pass
  } else {
    const int64_t rows = (int64_t)a.B * a.H * a.Sq;
    const unsigned blocks = (unsigned)((rows * (D / 8) + PT - 1) / PT);
    bwd_post_kernel<T, D><<<blocks, PT, 0, st>>>(
        a.dq_part, (T*)a.dq, a.s[SDQ], a.H, a.Sq, a.Skv, a.causal, a.window,
        rows, a.scale);
    return (int)cudaGetLastError();
  }
}

// the launches `parts` asks for, in order; the host work (tensor maps)
// comes before the first, so the kernels follow each other on the stream
template <typename T, int D>
int launch_t(int parts, const Args& a, cudaStream_t st) {
  Maps m;
  int err = 0;
  if constexpr (D == HD && !std::is_same<T, float>::value)
    if ((parts & 2) && (err = encode_maps<T>(&m, a))) return err;
  if ((parts & 1) && (err = launch_prep<T, D>(a, st))) return err;
  if ((parts & 2) && (err = launch_main<T, D>(m, a, st))) return err;
  if (parts & 4) err = launch_post<T, D>(a, st);
  return err;
}

template <int D>
int launch(int parts, int dtype, const Args& a, cudaStream_t st) {
  if (dtype == 0) return launch_t<float, D>(parts, a, st);
  if (dtype == 1) return launch_t<bf16, D>(parts, a, st);
  return launch_t<f16, D>(parts, a, st);
}

static_assert(HC == KV_TILE && BC == KV_TILE,
              "both 16-bit main passes take KV_TILE keys a block");
static_assert(tile_rows<HD>() == HR,
              "the post-pass finds the Dh-64 q tiles by tile_rows");

}  // namespace

// The backward's launches, chosen by the bits of `parts`: 1 the pre-pass, 2
// the main pass, 4 the post-pass (16-bit only).  dtype: 0 = float32, 1 =
// bfloat16, 2 = float16 (16-bit rows 16-byte aligned).  D: 32, 64 or 128.
// strides: the (batch, head, seq) strides in elements of q, k, v, out,
// dout, dq, dk, dv (24 values).  lse is the forward's contiguous (B, H, Sq)
// fp32; delta and, in 16 bits, lse2 = lse * log2(e) are (B H, pitch) fp32,
// pitch Sq in fp32 and Sq rounded up to a multiple of 64 in 16 bits;
// dq_part (16-bit only) is the contiguous (ceil(Skv / KV_TILE), B, H, Sq,
// D) fp32 buffer of the main pass's dQ partials, one slice a KV tile, which
// the post-pass adds in tile order; it may be null when Skv <= KV_TILE:
// then each q row's dQ comes from one block, which writes dq itself (no
// partials, no post-pass).  A null buffer over more keys, or a post-pass
// without one, is refused (cudaErrorInvalidValue).  In fp32 the main pass
// always writes dq itself and dq_part must be null.  Returns the first
// failing launch's cudaGetLastError().
extern "C" int flash_bwd(int parts, int dtype, int D, const void* q,
                         const void* k, const void* v, const void* out,
                         const void* dout, const float* lse, float* lse2,
                         float* delta, int pitch, void* dq, float* dq_part,
                         void* dk, void* dv, const int64_t* strides, int B,
                         int H, int Sq, int Skv, int causal, int window,
                         float softcap, float scale, void* stream) {
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  if (dq_part == nullptr ? (parts & 4) || (dtype != 0 && Skv > KV_TILE)
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
  a.dq_part = dq_part;
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
