// Fused bias + tanh-GELU forward and backward for Hopper (sm_90a).
//
// The forward replaces the TPU kernel repro/kernels/bias_gelu.py:42
// `bias_gelu` / `_bias_gelu_kernel` (:20), the paper's §4.3 fusion example:
// with y = x + b in fp32, out = 0.5 y (1 + tanh(sqrt(2/pi) (y + 0.044715
// y^3))), rounded once to x's dtype (float32, bfloat16 or float16).
//
// Translation.  The TPU kernel takes (256, d) row tiles with the bias
// broadcast from VMEM.  Here the (rows, d) matrix is one flat array walked
// by a grid-stride loop of 16-byte vectors (8 16-bit values or 4 floats a
// thread, neighbouring threads on neighbouring addresses); d is a multiple
// of the vector, so a vector never crosses a row and its bias is one
// 16-byte load at column (index % d), which stays in L1/L2.
//
// Bound.  ~20 FLOP and one tanh per element against 4 bytes (bf16 in and
// out): bytes bound it.  At the BERT-large phase-1 MLP shape
// (8192 x 4096 bf16) that is 134 MB, 40 us at 3.35 TB/s.
//
// The backward (`bias_gelu_bwd_kernel`, then `colsum_kernel`) has no TPU
// kernel to replace: the JAX package leaves it to XLA's autodiff, fused on
// the TPU.  With y = x + b and t = tanh(sqrt(2/pi) (y + 0.044715 y^3)) in
// fp32:
//   dx = dy (0.5 (1 + t) + 0.5 y (1 - t^2) sqrt(2/pi) (1 + 3 0.044715 y^2))
// rounded once to x's dtype (an f16 overflow stays inf), and db = the sum
// of the fp32 dx over the rows.  The forward's flat loop cannot give column
// sums, so the backward tiles rows x 16-byte vectors: a block of 128
// threads owns 128 adjacent column vectors of a tile of 64 rows, each
// thread walks its vector down the tile (coalesced rows of 2 KB in bf16),
// keeps its columns' db sums in registers and writes them as one fp32
// partial row of the tile.  A second small pass (colsum_kernel, rows.cuh)
// adds the tiles' partials column by column, in tile order.  No
// floating-point atomics: dx and db are bit-identical from run to run.
//
// Its bound: x and dy read, dx written, b read once: 6 bytes an element in
// bf16 against ~30 FLOP and one tanh, so bytes.  At phase 2 (16384 x 4096
// bf16) 402.7 MB, 0.120 ms at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BT = 128;   // threads (column vectors) a block of the backward
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kC = 0.044715f;

template <typename T>
__global__ void __launch_bounds__(THREADS)
bias_gelu_kernel(const T* __restrict__ x, const T* __restrict__ b,
                 T* __restrict__ out, int64_t n_vec, int d) {
  constexpr int E = 16 / sizeof(T);
  for (int64_t i = blockIdx.x * (int64_t)THREADS + threadIdx.x; i < n_vec;
       i += (int64_t)gridDim.x * THREADS) {
    const int64_t e0 = i * E;
    float xv[E], bv[E], o[E];
    load16(x + e0, xv);
    load16(b + (int)(e0 % d), bv);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float y = xv[e] + bv[e];
      const float inner = kSqrt2OverPi * (y + kC * y * y * y);
      o[e] = 0.5f * y * (1.f + tanhf(inner));
    }
    store16(out + e0, o);
  }
}

template <typename T>
int launch_t(const void* x, const void* b, void* out, int64_t n, int d,
             cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const int64_t n_vec = n / E;
  const int64_t want = (n_vec + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  if (blocks == 0) return 0;
  bias_gelu_kernel<T><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<T*>(out),
      n_vec, d);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Grid (column blocks of BT vectors, row tiles of `tile` rows).  part:
// (gridDim.y, d) fp32, the tile's db sums.
template <typename T>
__global__ void __launch_bounds__(BT)
bias_gelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ b,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ part, int rows, int d, int tile) {
  constexpr int E = 16 / sizeof(T);
  const int col = (blockIdx.x * BT + threadIdx.x) * E;
  if (col >= d) return;
  const int r0 = blockIdx.y * tile, r1 = min(r0 + tile, rows);
  float bv[E], acc[E];
  load16(b + col, bv);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const int64_t at = (int64_t)r * d + col;
    float xv[E], gv[E], o[E];
    load16(x + at, xv);
    load16(dy + at, gv);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float y = xv[e] + bv[e];
      const float t = tanhf(kSqrt2OverPi * (y + kC * y * y * y));
      const float dg = 0.5f * (1.f + t) + 0.5f * y * (1.f - t * t) *
                                              kSqrt2OverPi *
                                              (1.f + 3.f * kC * y * y);
      o[e] = gv[e] * dg;
      acc[e] += o[e];
    }
    store16(dx + at, o);
  }
  float* dst = part + (int64_t)blockIdx.y * d + col;
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = acc[e];
}

template <typename T>
int launch_bwd_t(const void* x, const void* b, const void* dy, void* dx,
                 void* db, float* part, int rows, int d, int tile,
                 cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const int n = (rows + tile - 1) / tile;
  const dim3 grid((d / E + BT - 1) / BT, n);
  if (n == 0) return 0;
  bias_gelu_bwd_kernel<T><<<grid, BT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, d, tile);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  colsum_kernel<T><<<(d + 31) / 32, 256, 0, st>>>(
      part, n, d, d, static_cast<T*>(db), static_cast<T*>(nullptr));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, b and out).  x and out
// are contiguous with n elements in rows of d, d a multiple of the 16-byte
// vector (4 floats, 8 16-bit values); x, b and out 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int bias_gelu_fwd(int dtype, const void* x, const void* b,
                             void* out, int64_t n, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float>(x, b, out, n, d, s);
  if (dtype == 1) return launch_t<__nv_bfloat16>(x, b, out, n, d, s);
  if (dtype == 2) return launch_t<__half>(x, b, out, n, d, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: dx (x's dtype, contiguous (rows, d)) and db ((d,), b's
// dtype, which is x's) from x, b and dy, laid out and coded as for
// bias_gelu_fwd (dy like x).  tile: rows a block; part: float32 scratch of
// (ceil(rows / tile), d).  Two launches; returns the first failing one's
// error.
extern "C" int bias_gelu_bwd(int dtype, const void* x, const void* b,
                             const void* dy, void* dx, void* db, float* part,
                             int rows, int d, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd_t<float>(x, b, dy, dx, db, part, rows, d, tile, s);
  if (dtype == 1)
    return launch_bwd_t<__nv_bfloat16>(x, b, dy, dx, db, part, rows, d, tile,
                                       s);
  if (dtype == 2)
    return launch_bwd_t<__half>(x, b, dy, dx, db, part, rows, d, tile, s);
  return (int)cudaErrorInvalidValue;
}
