// RWKV-6 chunk recurrence (WKV6) for Hopper (sm_90a), fp32 arithmetic with
// the products on tensor cores in 3xTF32.
//
// Replaces the TPU kernel repro/kernels/wkv6.py:98 `wkv6` / `_wkv6_kernel`
// (:32).  What it computes is the same: per (batch, head), over chunks of
// L <= 64 tokens in order, with c the inclusive cumulative sum of the log
// decay over the chunk and c_prev_i = c_{i-1} (0 for the chunk's first
// row),
//
//   A[i,j] = sum_c r_i[c] k_j[c] e^{c_prev_i[c] - c_j[c]}        (j < i)
//   o_i    = sum_{j<i} A[i,j] v_j + (r_i . (u * k_i)) v_i + (r_i * e^{c_prev_i}) S
//   S     <- diag(e^{c_L}) S + sum_j (k_j * e^{c_L - c_j})^T v_j
//
// Sub-chunk scores.  logw <= 0, so c falls along the chunk.  Cut the chunk
// into sub-chunks of SUB = 16 rows (the last one shorter when L % 16 != 0)
// and let c_ref(I) be the c of the last row of sub-chunk I - 1.  For i in
// sub-chunk I and j in an earlier sub-chunk, c_prev_i <= c_ref(I) <= c_j,
// so
//
//   e^{c_prev_i - c_j} = e^{c_prev_i - c_ref(I)} * e^{c_ref(I) - c_j}
//
// with both exponents <= 0: the off-diagonal blocks of A are one product
// (r_I * e^{c_prev_I - c_ref}) (k_J * e^{c_ref - c_J})^T, and a strong decay
// underflows each factor to 0 without either overflowing.  There is no
// e^{+c} factor anywhere (no q e^{c} / k e^{-c} factorisation, as in the
// reference).  Only the four 16 x 16 diagonal blocks keep one exponential
// per (i, j < i, c), on CUDA cores, with the bonus r_i . (u * k_i) on their
// diagonal.  c is kept scaled by log2(e), so each exponential is one ex2.
//
// 3xTF32 products.  The off-diagonal scores, A V, (r * e^{c_prev}) S and the
// state update run on `mma.sync.m16n8k8` TF32 with fp32 accumulators.  A
// plain TF32 rounding of the operands misses the reference's 1e-4 (max
// error ~4e-2 on o, kernels/ref.py `wkv6_subchunk_ref`), so every operand
// x is split into x_big (x cut to TF32) and x_small = x - x_big, and a
// product is a_small b_big + a_big b_small + a_big b_big (`mma3x`).  A bf16
// value is exact in TF32: v's small part is zero when v is bf16, and its
// term is skipped (`split_b`, `mma3x<b_exact>`: A V and the state update).
//
// Grid.  Blocks run in no order, and the TPU kernel's sequential chunk axis
// carries S from chunk to chunk, so one block of 8 warps owns a (b, h) --
// or, where B * H blocks would leave most SMs idle, a slice of 32 of S's 64
// value columns, the scores recomputed by each slice (kernels/wkv6.py
// `plan`, from the shapes alone) -- and walks its chunks in order with its
// slice of S in shared memory.  Each chunk is staged by 16-byte `cp.async`
// into one half of a two-stage ring while the previous one computes (plain
// loads when a row is not 16-byte aligned), read in place through the
// (B, S, H) strides of r, k, v, logw.  Per chunk, between barriers:
//   1. the cumulative sum, a warp scan (8 rows a lane, 3 shuffle steps);
//   2. the diagonal blocks (warps w and w + 4 take the two halves of the
//      channels of sub-chunk w & 3, summed when read), the off-diagonal
//      scores (two n-tiles a warp, warps 0..5) and r * e^{c_prev} (warps
//      6, 7), all into shared memory;
//   3. o, each warp two row tiles ({0, 3} or {1, 2}, equal work) over a
//      quarter of the columns;
//   4. the state update, each warp 16 key channels over half the columns.
// No floating-point atomics: a relaunch gives the same bits.
//
// Bound.  At the serving path's prefill shape (B 4, S 1024, H 32, hs 64,
// bf16 r/k/v, 16 chunks of 64) a launch must move ~121.6 MB (r, k, v in
// bf16, logw and o in fp32, u, the two states): 0.0363 ms at 3.35 TB/s.
// The sub-chunk form needs ~99 M exponentials and ~3.6 GFLOP of products
// (~7.9 G TF32 flops as run), so bytes bound it (chip_smoke.py
// `wkv6_bound`).  Each block walks 16 chunks in a chain of barriers with
// one block an SM (8 warps), so latency, not bytes, holds it there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HS = 64;          // head size
constexpr int LMAX = 64;        // longest chunk
constexpr int SUB = 16;         // rows of a sub-chunk
constexpr int NSUB = LMAX / SUB;
constexpr int THREADS = 256;    // 8 warps
constexpr int CST = HS + 4;     // row stride (floats) of c and r e^{c_prev}
constexpr int SST = HS + 8;     // row stride (floats) of the state
constexpr int PST = HS + 4;     // row stride (floats) of the scores
constexpr int DST = SUB + 4;    // row stride (floats) of a diagonal block
constexpr float LOG2E = 1.4426950408889634f;
// the off-diagonal scores in pairs of n-tiles (I, first n-tile), one a warp
__constant__ int OFF_I[6] = {1, 2, 2, 3, 3, 3};
__constant__ int OFF_NT[6] = {0, 0, 2, 0, 2, 4};

struct Strides {   // element strides of the (B, S, H) axes of r, k, v, logw
  int64_t b[4], s[4], h[4];
};

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const void* u;
  const float* s0;
  float* o;
  float* s_final;
  Strides st;
  int H, S, L, nc, nsplit;
  bool aligned;      // every row 16-byte aligned: cp.async
};

template <typename T>
struct Layout {   // byte layout of a block's shared memory
  static constexpr int TS = HS + 16 / (int)sizeof(T);  // row stride of r, k, v
  static constexpr int T_BYTES = LMAX * TS * (int)sizeof(T);
  // a stage: r, k, v, c (logw, scanned in place)
  static constexpr int STAGE = 3 * T_BYTES + LMAX * CST * 4;
  static constexpr int S_OFF = 2 * STAGE;                       // S slice
  static constexpr int P_OFF = S_OFF + HS * SST * 4;           // scores
  static constexpr int P1_OFF = P_OFF + LMAX * PST * 4;        // diagonal
  static constexpr int RH_OFF = P1_OFF + NSUB * SUB * DST * 4; // r e^{c_prev}
  static constexpr int TOTAL = RH_OFF + LMAX * CST * 4;
};

struct Stage {
  const void* r;
  const void* k;
  const void* v;
  float* c;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive elements as floats (8- or 16-byte shared loads)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// x = big + small: big is x truncated to TF32 (sign, exponent and 10
// mantissa bits), small the exact rest, whose low 13 bits the tensor core
// ignores as it reads a TF32 operand
struct Split {
  uint32_t big, small;
};
__device__ __forceinline__ Split split(float x) {
  Split s;
  s.big = __float_as_uint(x) & 0xffffe000u;
  s.small = __float_as_uint(x - __uint_as_float(s.big));
  return s;
}

// a value known to be exact in TF32 (bf16 data): no rounding, small part 0
template <bool exact>
__device__ __forceinline__ Split split_b(float x) {
  if (exact) return Split{__float_as_uint(x), 0u};
  return split(x);
}

__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: a_small b_big + a_big b_small + a_big b_big, the
// small terms into ds and the big one into db (two accumulator chains, added
// by the caller; mma3 passes one accumulator as both).  With b_exact (b is
// bf16 data, exact in TF32) b_small is zero and its term goes.
template <bool b_exact>
__device__ __forceinline__ void mma3x(float db[4], float ds[4],
                                      const Split a[4], const Split b[2]) {
  const uint32_t ab[4] = {a[0].big, a[1].big, a[2].big, a[3].big};
  const uint32_t as[4] = {a[0].small, a[1].small, a[2].small, a[3].small};
  const uint32_t bb[2] = {b[0].big, b[1].big};
  const uint32_t bs[2] = {b[0].small, b[1].small};
  mma(ds, as, bb);   // the small terms
  if (!b_exact) mma(ds, ab, bs);
  mma(db, ab, bb);
}
template <bool b_exact>
__device__ __forceinline__ void mma3(float d[4], const Split a[4],
                                     const Split b[2]) {
  mma3x<b_exact>(d, d, a, b);
}

// Copy L rows of 64 elements (row stride `stride` in global, `dst_stride`
// in shared) with 16-byte cp.async, or plain loads when not aligned.
template <typename E>
__device__ __forceinline__ void stage_rows(E* dst, int dst_stride,
                                           const E* src, int64_t stride,
                                           int L, bool aligned, int tid) {
  constexpr int VEC = 16 / (int)sizeof(E);
  constexpr int PER_ROW = HS / VEC;
  if (aligned) {
    for (int e = tid; e < L * PER_ROW; e += THREADS) {
      const int i = e / PER_ROW, q = e % PER_ROW;
      cp16(dst + i * dst_stride + q * VEC, src + i * stride + q * VEC);
    }
  } else {
    for (int e = tid; e < L * HS; e += THREADS) {
      const int i = e / HS, c = e % HS;
      dst[i * dst_stride + c] = src[i * stride + c];
    }
  }
}

// Stage chunk rows t0 .. t0 + L - 1 of (b, h).  Rows L .. 63 are never
// written: they stay zero (r, k, v) or are read as zero (logw).
template <typename T>
__device__ __forceinline__ void stage_chunk(const Args& a, const Stage& st,
                                            int b, int h, int t0, int tid) {
  constexpr int TS = Layout<T>::TS;
  const Strides& s = a.st;
  stage_rows((T*)st.r, TS,
             (const T*)a.r + b * s.b[0] + h * s.h[0] + t0 * s.s[0], s.s[0],
             a.L, a.aligned, tid);
  stage_rows((T*)st.k, TS,
             (const T*)a.k + b * s.b[1] + h * s.h[1] + t0 * s.s[1], s.s[1],
             a.L, a.aligned, tid);
  stage_rows((T*)st.v, TS,
             (const T*)a.v + b * s.b[2] + h * s.h[2] + t0 * s.s[2], s.s[2],
             a.L, a.aligned, tid);
  stage_rows(st.c, CST, a.logw + b * s.b[3] + h * s.h[3] + t0 * s.s[3],
             s.s[3], a.L, a.aligned, tid);
}

// In place: logw -> c * log2(e), the inclusive cumulative sum over the
// chunk's rows (rows >= L read as 0, so every row past the chunk holds
// c_L).  Warp w scans channels 16w .. 16w + 15: lane (seg, q) sums rows
// 8 seg .. 8 seg + 7 of channels 16w + 4q .. + 3, then the 8 segments'
// totals are scanned across lanes in 3 shuffle steps.
__device__ __forceinline__ void scan_c(float* c, int L, int warp, int lane) {
  const int seg = lane >> 2, ch = 16 * warp + 4 * (lane & 3);
  float4 x[8];
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = seg * 8 + i;
    const float4 w = row < L ? ld4(c + row * CST + ch)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    run.x += w.x * LOG2E;
    run.y += w.y * LOG2E;
    run.z += w.z * LOG2E;
    run.w += w.w * LOG2E;
    x[i] = run;
  }
  float4 tot = run;
#pragma unroll
  for (int d = 1; d < 8; d <<= 1) {
    const float ox = __shfl_up_sync(0xffffffffu, tot.x, 4 * d);
    const float oy = __shfl_up_sync(0xffffffffu, tot.y, 4 * d);
    const float oz = __shfl_up_sync(0xffffffffu, tot.z, 4 * d);
    const float ow = __shfl_up_sync(0xffffffffu, tot.w, 4 * d);
    if (seg >= d) {
      tot.x += ox;
      tot.y += oy;
      tot.z += oz;
      tot.w += ow;
    }
  }
  // the sum of the earlier segments: the inclusive total one segment back
  float4 pre;
  pre.x = __shfl_up_sync(0xffffffffu, tot.x, 4);
  pre.y = __shfl_up_sync(0xffffffffu, tot.y, 4);
  pre.z = __shfl_up_sync(0xffffffffu, tot.z, 4);
  pre.w = __shfl_up_sync(0xffffffffu, tot.w, 4);
  if (seg == 0) pre = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(c + (seg * 8 + i) * CST + ch) = make_float4(
        pre.x + x[i].x, pre.y + x[i].y, pre.z + x[i].z, pre.w + x[i].w);
}

// The diagonal block of sub-chunk I over channels cb .. cb + nch - 1 into d
// (16 rows of stride ds; entries above the diagonal never written, so they
// stay zero).  One warp: lanes 0..27 each own a 2 x 2
// tile of rows 2 ti, 2 ti + 1 and columns 2 tj, 2 tj + 1 with ti > tj;
// lanes 28..31 the pairs (4q + 1, 4q) and (4q + 3, 4q + 2) that the tiles
// leave out, run through the same loop with the other two entries masked
// (their exponents clamped to <= 0 first).  One ex2 per (entry, channel).
// Lanes 0..15 then add the bonus r_i . (u * k_i) on the diagonal.
template <typename T>
__device__ __forceinline__ void diag_block(const Stage& st, const float* us,
                                           float* d, int ds, int I, int lane,
                                           int cb, int nch) {
  constexpr int TS = Layout<T>::TS;
  int ri0, ri1, cj0, cj1;   // rows and columns within the sub-chunk
  float m01 = 1.f, m10 = 1.f;
  if (lane < 28) {
    int ti = 1, f = lane;
    while (f >= ti) {
      f -= ti;
      ++ti;
    }
    ri0 = 2 * ti;
    ri1 = ri0 + 1;
    cj0 = 2 * f;
    cj1 = cj0 + 1;
  } else {
    const int q = lane - 28;
    ri0 = 4 * q + 1;
    ri1 = 4 * q + 3;
    cj0 = 4 * q;
    cj1 = 4 * q + 2;
    m01 = 0.f;   // (4q + 1, 4q + 2): above the diagonal
    m10 = 0.f;   // (4q + 3, 4q): a tile's
  }
  const int base = SUB * I;
  const T* r0 = (const T*)st.r + (base + ri0) * TS + cb;
  const T* r1 = (const T*)st.r + (base + ri1) * TS + cb;
  const T* k0 = (const T*)st.k + (base + cj0) * TS + cb;
  const T* k1 = (const T*)st.k + (base + cj1) * TS + cb;
  const float* p0 = st.c + (base + ri0 - 1) * CST + cb;   // c_prev of the rows
  const float* p1 = st.c + (base + ri1 - 1) * CST + cb;
  const float* q0 = st.c + (base + cj0) * CST + cb;
  const float* q1 = st.c + (base + cj1) * CST + cb;
  float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll 4
  for (int c = 0; c < nch; c += 4) {
    const float4 x0 = ld4(r0 + c), x1 = ld4(r1 + c);
    const float4 y0 = ld4(k0 + c), y1 = ld4(k1 + c);
    const float4 e0 = ld4(p0 + c), e1 = ld4(p1 + c);
    const float4 f0 = ld4(q0 + c), f1 = ld4(q1 + c);
#define WKV_TERM(comp)                                                  \
  a00 += x0.comp * y0.comp * ex2(fminf(e0.comp - f0.comp, 0.f));        \
  a01 += x0.comp * y1.comp * ex2(fminf(e0.comp - f1.comp, 0.f));        \
  a10 += x1.comp * y0.comp * ex2(fminf(e1.comp - f0.comp, 0.f));        \
  a11 += x1.comp * y1.comp * ex2(fminf(e1.comp - f1.comp, 0.f));
    WKV_TERM(x)
    WKV_TERM(y)
    WKV_TERM(z)
    WKV_TERM(w)
#undef WKV_TERM
  }
  d[ri0 * ds + cj0] = a00;
  d[ri1 * ds + cj1] = a11;
  if (m01 != 0.f) d[ri0 * ds + cj1] = a01;
  if (m10 != 0.f) d[ri1 * ds + cj0] = a10;
  // bonus: lanes i and i + 16 take half the channels each
  const int i = lane & 15, c0 = cb + (lane >> 4) * (nch / 2);
  const T* ri = (const T*)st.r + (base + i) * TS + c0;
  const T* ki = (const T*)st.k + (base + i) * TS + c0;
  float bonus = 0.f;
#pragma unroll 4
  for (int c = 0; c < nch / 2; c += 4) {
    const float4 x = ld4(ri + c), y = ld4(ki + c), w = ld4(us + c0 + c);
    bonus += x.x * w.x * y.x + x.y * w.y * y.y + x.z * w.z * y.z +
             x.w * w.w * y.w;
  }
  bonus += __shfl_down_sync(0xffffffffu, bonus, 16);
  if (lane < 16) d[i * ds + i] = bonus;
}

// Key channels 16 w .. 16 w + 15 of the state update over NT n-tiles from
// column c0 of the slice (column n0 + c0 of V): acc = e^{c_L} S + (k *
// e^{c_L - c})^T V over the chunk's rows, in C fragments (rows g, g + 8;
// columns 8 n + 2t, + 1).
template <typename T, int NT>
__device__ __forceinline__ void state_update(const Stage& st, const float* S,
                                             float acc[NT][4], int L, int w,
                                             int lane, int n0, int c0 = 0) {
  float accs[NT][4] = {};   // the small products, added at the end
  constexpr int TS = Layout<T>::TS;
  constexpr bool VX = sizeof(T) == 2;
  const int g = lane >> 2, t = lane & 3;
  const int ch0 = SUB * w + g, ch1 = ch0 + 8;
  const float* cl = st.c + (LMAX - 1) * CST;   // c_L (rows >= L hold it)
  const float cl0 = cl[ch0], cl1 = cl[ch1];
  const float e0 = ex2(cl0), e1 = ex2(cl1);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = c0 + 8 * n + 2 * t;
    acc[n][0] = e0 * S[ch0 * SST + col];
    acc[n][1] = e0 * S[ch0 * SST + col + 1];
    acc[n][2] = e1 * S[ch1 * SST + col];
    acc[n][3] = e1 * S[ch1 * SST + col + 1];
  }
  const T* kk = (const T*)st.k;
  const T* vv = (const T*)st.v + n0 + c0;
  const int rows = (L + SUB - 1) / SUB * SUB;
#pragma unroll 1
  for (int jb = 0; jb < rows; jb += 8) {
    const int j0 = jb + t, j1 = jb + t + 4;
    const Split af[4] = {
        split(to_f(kk[j0 * TS + ch0]) * ex2(cl0 - st.c[j0 * CST + ch0])),
        split(to_f(kk[j0 * TS + ch1]) * ex2(cl1 - st.c[j0 * CST + ch1])),
        split(to_f(kk[j1 * TS + ch0]) * ex2(cl0 - st.c[j1 * CST + ch0])),
        split(to_f(kk[j1 * TS + ch1]) * ex2(cl1 - st.c[j1 * CST + ch1]))};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const Split bf[2] = {split_b<VX>(to_f(vv[j0 * TS + 8 * n + g])),
                           split_b<VX>(to_f(vv[j1 * TS + 8 * n + g]))};
      mma3x<VX>(acc[n], accs[n], af, bf);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += accs[n][e];
}

template <typename T>
__device__ __forceinline__ Stage stage_at(unsigned char* base) {
  Stage s;
  s.r = base;
  s.k = base + Layout<T>::T_BYTES;
  s.v = base + 2 * Layout<T>::T_BYTES;
  s.c = reinterpret_cast<float*>(base + 3 * Layout<T>::T_BYTES);
  return s;
}

// zero rows L .. 63 of a stage's r, k, v (never written by the copies)
template <typename T>
__device__ __forceinline__ void zero_tail(const Stage& st, int L, int tid) {
  constexpr int TS = Layout<T>::TS;
  const T zero = from_f<T>(0.f);
  for (int e = tid; e < (LMAX - L) * TS; e += THREADS) {
    const int i = L + e / TS, c = e % TS;
    ((T*)st.r)[i * TS + c] = zero;
    ((T*)st.k)[i * TS + c] = zero;
    ((T*)st.v)[i * TS + c] = zero;
  }
}

// n-tiles nt0, nt0 + 1 of sub-chunk I's off-diagonal scores into P:
// A = r_I * e^{c_prev_I - c_ref}, B^T = k_J * e^{c_ref - c_J}, both built as
// their fragments are loaded
template <typename T>
__device__ __forceinline__ void offdiag_pair(const Stage& st, float* P,
                                             int I, int nt0, int lane) {
  constexpr int TS = Layout<T>::TS;
  const int g = lane >> 2, t = lane & 3;
  const int row = SUB * I + g;
  const T* rr = (const T*)st.r;
  const T* kk = (const T*)st.k;
  const float* cref = st.c + (SUB * I - 1) * CST;
  float sc[2][4] = {};
#pragma unroll 2
  for (int kb = 0; kb < HS; kb += 8) {
    const int c0 = kb + t, c1 = kb + t + 4;
    const float cr0 = cref[c0], cr1 = cref[c1];
    Split a[4];
    a[0] = split(to_f(rr[row * TS + c0]) *
                 ex2(st.c[(row - 1) * CST + c0] - cr0));
    a[1] = split(to_f(rr[(row + 8) * TS + c0]) *
                 ex2(st.c[(row + 7) * CST + c0] - cr0));
    a[2] = split(to_f(rr[row * TS + c1]) *
                 ex2(st.c[(row - 1) * CST + c1] - cr1));
    a[3] = split(to_f(rr[(row + 8) * TS + c1]) *
                 ex2(st.c[(row + 7) * CST + c1] - cr1));
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = 8 * (nt0 + q) + g;
      Split b[2];
      b[0] = split(to_f(kk[j * TS + c0]) * ex2(cr0 - st.c[j * CST + c0]));
      b[1] = split(to_f(kk[j * TS + c1]) * ex2(cr1 - st.c[j * CST + c1]));
      mma3<false>(sc[q], a, b);
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int col = 8 * (nt0 + q) + 2 * t;
    *reinterpret_cast<float2*>(P + row * PST + col) =
        make_float2(sc[q][0], sc[q][1]);
    *reinterpret_cast<float2*>(P + (row + 8) * PST + col) =
        make_float2(sc[q][2], sc[q][3]);
  }
}

// rh = r * e^{c_prev} over the chunk's rows, by the 64 threads of warps 6, 7
template <typename T>
__device__ __forceinline__ void r_decayed(const Stage& st, float* rh, int tid) {
  constexpr int TS = Layout<T>::TS;
  for (int e = tid; e < LMAX * HS / 4; e += 64) {
    const int i = e / (HS / 4), c = 4 * (e % (HS / 4));
    const float4 x = ld4((const T*)st.r + i * TS + c);
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i) p = ld4(st.c + (i - 1) * CST + c);
    *reinterpret_cast<float4*>(rh + i * CST + c) = make_float4(
        x.x * ex2(p.x), x.y * ex2(p.y), x.z * ex2(p.z), x.w * ex2(p.w));
  }
}

// o for this warp's row tiles {0, 3} or {1, 2} and NT n-tiles from local
// column c0: P V over the blocks on and below the diagonal (the diagonal
// block is P + P1, the two halves of its channel sum) plus rh S.  The two
// row tiles share each B fragment, and the big and small products go to
// separate accumulators: eight independent mma chains a warp at NT 2.
template <typename T, int NT>
__device__ __forceinline__ void seq_out(const Args& a, const Stage& st,
                                        const float* S, const float* P,
                                        const float* P1, const float* rh,
                                        int warp, int lane, int b, int h,
                                        int t0, int n0, int c0, int nsub) {
  constexpr int TS = Layout<T>::TS;
  constexpr bool VX = sizeof(T) == 2;
  const int g = lane >> 2, t = lane & 3;
  const T* vv = (const T*)st.v + n0 + c0;
  const int tile[2] = {(warp & 1) ? 1 : 0, (warp & 1) ? 2 : 3};
  const bool live[2] = {tile[0] < nsub, tile[1] < nsub};
  float accb[2][NT][4] = {}, accs[2][NT][4] = {};
  // A fragment of row tile x at columns kb + t, + 4 of P (+ P1 on the
  // diagonal block)
  auto p_frag = [&](int x, int kb, Split af[4]) {
    const int row = SUB * tile[x] + g;
    float v0 = P[row * PST + kb + t], v1 = P[(row + 8) * PST + kb + t];
    float v2 = P[row * PST + kb + t + 4], v3 = P[(row + 8) * PST + kb + t + 4];
    if (kb >= SUB * tile[x]) {
      const float* d1 = P1 + tile[x] * SUB * DST + kb - SUB * tile[x];
      v0 += d1[g * DST + t];
      v1 += d1[(g + 8) * DST + t];
      v2 += d1[g * DST + t + 4];
      v3 += d1[(g + 8) * DST + t + 4];
    }
    af[0] = split(v0);
    af[1] = split(v1);
    af[2] = split(v2);
    af[3] = split(v3);
  };
  const int kend = SUB * (tile[1] + 1);   // tile[1] is the larger
#pragma unroll 1
  for (int kb = 0; kb < kend; kb += 8) {
    Split bf[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      bf[n][0] = split_b<VX>(to_f(vv[(kb + t) * TS + 8 * n + g]));
      bf[n][1] = split_b<VX>(to_f(vv[(kb + t + 4) * TS + 8 * n + g]));
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (!live[x] || kb >= SUB * (tile[x] + 1)) continue;
      Split af[4];
      p_frag(x, kb, af);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma3x<VX>(accb[x][n], accs[x][n], af, bf[n]);
    }
  }
#pragma unroll 2
  for (int kb = 0; kb < HS; kb += 8) {
    Split bf[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      bf[n][0] = split(S[(kb + t) * SST + c0 + 8 * n + g]);
      bf[n][1] = split(S[(kb + t + 4) * SST + c0 + 8 * n + g]);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int row = SUB * tile[x] + g;
      const Split af[4] = {split(rh[row * CST + kb + t]),
                           split(rh[(row + 8) * CST + kb + t]),
                           split(rh[row * CST + kb + t + 4]),
                           split(rh[(row + 8) * CST + kb + t + 4])};
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma3x<false>(accb[x][n], accs[x][n], af, bf[n]);
    }
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = SUB * tile[x] + g + 8 * half;
      if (!live[x] || i >= a.L) continue;
      float* op = a.o + (((int64_t)b * a.S + t0 + i) * a.H + h) * HS + n0 +
                  c0 + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(op + 8 * n) = make_float2(
            accb[x][n][2 * half] + accs[x][n][2 * half],
            accb[x][n][2 * half + 1] + accs[x][n][2 * half + 1]);
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_kernel(Args a) {
  using L_ = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float us[HS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x / a.nsplit, n0 = (blockIdx.x % a.nsplit) * NC;
  const int b = bh / a.H, h = bh % a.H;
  float* S = reinterpret_cast<float*>(smem + L_::S_OFF);
  float* P = reinterpret_cast<float*>(smem + L_::P_OFF);
  float* P1 = reinterpret_cast<float*>(smem + L_::P1_OFF);
  float* rh = reinterpret_cast<float*>(smem + L_::RH_OFF);
  const int nsub = (a.L + SUB - 1) / SUB;

  stage_chunk<T>(a, stage_at<T>(smem), b, h, 0, tid);
  cp_commit();
  if (tid < HS) us[tid] = to_f(((const T*)a.u)[h * HS + tid]);
  const float* s0 = a.s0 + (int64_t)bh * HS * HS + n0;
  for (int e = tid; e < HS * NC; e += THREADS)
    S[(e / NC) * SST + e % NC] = s0[(e / NC) * HS + e % NC];
  for (int e = tid; e < LMAX * PST; e += THREADS) P[e] = 0.f;
  for (int e = tid; e < NSUB * SUB * DST; e += THREADS) P1[e] = 0.f;
  if (a.L < LMAX) {
    zero_tail<T>(stage_at<T>(smem), a.L, tid);
    zero_tail<T>(stage_at<T>(smem + L_::STAGE), a.L, tid);
  }
  for (int n = 0; n < a.nc; ++n) {
    const Stage st = stage_at<T>(smem + (n & 1) * L_::STAGE);
    cp_wait_all();
    __syncthreads();   // chunk n landed; chunk n - 1 done with its stage
    if (n + 1 < a.nc) {
      stage_chunk<T>(a, stage_at<T>(smem + ((n + 1) & 1) * L_::STAGE), b, h,
                     (n + 1) * a.L, tid);
      cp_commit();
    }
    if (warp < 4) scan_c(st.c, a.L, warp, lane);
    __syncthreads();
    // scores: the diagonal blocks, channels split between warps w and w + 4
    const int I = warp & 3, hf = warp >> 2;
    if (I < nsub) {
      if (hf == 0)
        diag_block<T>(st, us, P + SUB * I * PST + SUB * I, PST, I, lane, 0,
                      HS / 2);
      else
        diag_block<T>(st, us, P1 + I * SUB * DST, DST, I, lane, HS / 2,
                      HS / 2);
    }
    // then the off-diagonal n-tile pairs (warps 0..5) and r e^{c_prev}
    // (warps 6, 7)
    if (warp < 6) {
      if (OFF_I[warp] < nsub)
        offdiag_pair<T>(st, P, OFF_I[warp], OFF_NT[warp], lane);
    } else {
      r_decayed<T>(st, rh, tid - 192);
    }
    __syncthreads();
    // o: warp w, row tiles {0, 3} or {1, 2} by w & 1, NTW n-tiles from
    // column 8 NTW (w >> 1)
    constexpr int NTW = NC / 32;
    seq_out<T, NTW>(a, st, S, P, P1, rh, warp, lane, b, h, n * a.L, n0,
                    8 * NTW * (warp >> 1), nsub);
    __syncthreads();   // every warp has read S
    // the state update: warp w, key channels 16 (w & 3) .., NTS n-tiles
    // from column 8 NTS (w >> 2)
    constexpr int NTS = NC / 16;
    float acc[NTS][4];
    const int c0 = 8 * NTS * (warp >> 2);
    state_update<T, NTS>(st, S, acc, a.L, warp & 3, lane, n0, c0);
    const int g = lane >> 2, t = lane & 3, ch = SUB * (warp & 3) + g;
#pragma unroll
    for (int q = 0; q < NTS; ++q) {
      const int col = c0 + 8 * q + 2 * t;
      *reinterpret_cast<float2*>(S + ch * SST + col) =
          make_float2(acc[q][0], acc[q][1]);
      *reinterpret_cast<float2*>(S + (ch + 8) * SST + col) =
          make_float2(acc[q][2], acc[q][3]);
    }
  }
  __syncthreads();
  float* sf = a.s_final + (int64_t)bh * HS * HS + n0;
  for (int e = tid; e < HS * NC; e += THREADS)
    sf[(e / NC) * HS + e % NC] = S[(e / NC) * SST + e % NC];
}

template <typename T, int NC>
int launch_nc(const Args& a, int B, cudaStream_t stream) {
  constexpr int bytes = Layout<T>::TOTAL;
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<T, NC><<<B * a.H * a.nsplit, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const Args& a, int B, cudaStream_t stream) {
  return a.nsplit == 1 ? launch_nc<T, HS>(a, B, stream)
                       : launch_nc<T, HS / 2>(a, B, stream);
}

}  // namespace

// dtype (r, k, v and u): 0 = float32, 1 = bfloat16.  r, k, v, logw:
// (B, S, H, 64) with a contiguous last dim, element strides of their B, S
// and H axes in `strides` (host memory: the B strides of r, k, v, logw,
// then their S strides, then their H strides); logw float32.  u: (H, 64)
// contiguous; s0: (B, H, 64, 64) contiguous float32.  o receives
// (B, S, H, 64) contiguous float32, s_final (B, H, 64, 64) float32.  L (the
// chunk) is in [1, 64] and divides S.  nsplit (1 or 2): blocks a (b, h),
// each owning 64 / nsplit of the state's value columns.  aligned: every row
// of r, k, v, logw starts on 16 bytes.  Returns cudaGetLastError().
extern "C" int wkv6_fwd(int dtype, const void* r, const void* k,
                        const void* v, const float* logw, const void* u,
                        const float* s0, float* o, float* s_final,
                        const int64_t* strides, int B, int H, int S, int L,
                        int nsplit, int aligned, void* stream) {
  if (L < 1 || L > LMAX || S % L != 0 || B < 1 || H < 1 ||
      (nsplit != 1 && nsplit != 2))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.logw = logw;
  a.u = u;
  a.s0 = s0;
  a.o = o;
  a.s_final = s_final;
  for (int i = 0; i < 4; ++i) {
    a.st.b[i] = strides[i];
    a.st.s[i] = strides[4 + i];
    a.st.h[i] = strides[8 + i];
  }
  a.H = H;
  a.S = S;
  a.L = L;
  a.nc = S / L;
  a.nsplit = nsplit;
  a.aligned = aligned != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float>(a, B, s);
  if (dtype == 1) return launch_t<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
