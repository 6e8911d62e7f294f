// Row LayerNorm forward and backward for Hopper (sm_90a), fp32 statistics.
//
// The forward replaces the TPU kernel repro/kernels/layernorm.py:40
// `layernorm` / `_layernorm_kernel` (:16).  What it computes is the same:
// per row of d values, mean and variance in fp32 (the variance as the mean
// of squared deviations, two passes over the row, as jnp.var), y = (x -
// mean) * rsqrt(var + eps) * scale + bias, y in x's dtype (float32,
// bfloat16 or float16).  It also writes each row's mean and rstd (fp32)
// for the backward.
//
// Translation.  The TPU kernel normalises a (256, d) row tile held in VMEM
// per grid step.  Here one warp owns one row: each lane loads its share of
// the row as 16-byte vectors (neighbouring lanes on neighbouring addresses)
// into registers, the two sums are warp shuffles, and the row is written
// back from the same registers, so x is read once and y written once.
// Four warps (four rows) per block.
//
// Bound.  LayerNorm does ~8 FLOP per element against 4 bytes (bf16 in and
// out): far below the card's ~295 FLOP/byte, so bytes bound it.  At the
// BERT-large phase-1 shape (8192 x 1024 bf16) that is 33.6 MB, 10 us at
// 3.35 TB/s.
//
// The backward (`layernorm_bwd_kernel`, then `colsum_kernel`) has no TPU
// kernel to replace: the JAX package leaves it to XLA's autodiff of the
// forward, which XLA fuses on the TPU.  From x, dy, scale and the saved
// mean and rstd, with xhat = (x - mean) rstd and g = dy scale, all fp32:
//   dx     = rstd (g - mean(g) - xhat mean(g xhat))   rounded once to x's
//            dtype (an f16 overflow stays inf, for the loss scale to see)
//   dscale = sum over rows of dy xhat,  dbias = sum over rows of dy
// One warp owns a row as in the forward.  A block (8 warps) owns a tile of
// consecutive rows; each lane keeps its columns' dscale and dbias sums in
// registers over the rows of its warp, the block adds its warps' sums in a
// fixed tree in shared memory, and writes one fp32 partial row of 2 d
// values for its tile.  A second small pass (colsum_kernel, rows.cuh) adds
// the tiles' partials column by column, in tile order.  No floating-point
// atomics: the gradients are bit-identical from run to run.  At most 256
// tiles, so the partials stay small (2 MB at d 1024) and the second pass
// short.
//
// Its bound: x and dy read, dx written (6 bytes an element in bf16), ~12
// FLOP an element: bytes again.  At phase 2 (16384 x 1024 bf16) 100.7 MB,
// 30 us at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int WARPS = 4;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// NV: 16-byte vectors per lane (the row holds at most 32 * NV of them)
template <typename T, typename P, int NV>
__global__ void __launch_bounds__(WARPS * 32)
layernorm_kernel(const T* __restrict__ x, const P* __restrict__ scale,
                 const P* __restrict__ bias, T* __restrict__ y,
                 float* __restrict__ mean_out, float* __restrict__ rstd_out,
                 int rows, int d, float eps) {
  constexpr int E = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + (int64_t)row * d;
  float vals[NV][E];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (i * 32 + lane) * E;
    if (col < d) {
      load16(xr + col, vals[i]);
#pragma unroll
      for (int e = 0; e < E; ++e) sum += vals[i][e];
    }
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (i * 32 + lane) * E;
    if (col < d) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float c = vals[i][e] - mean;
        sq += c * c;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);
  T* yr = y + (int64_t)row * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (i * 32 + lane) * E;
    if (col < d) {
      float out[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        out[e] = (vals[i][e] - mean) * rstd * to_f(scale[col + e]) +
                 to_f(bias[col + e]);
      store16(yr + col, out);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, typename P>
int launch_t(int nv, const void* x, const void* scale, const void* bias,
             void* y, float* mean, float* rstd, int rows, int d, float eps,
             cudaStream_t st) {
  const dim3 grid((rows + WARPS - 1) / WARPS);
  const T* xp = static_cast<const T*>(x);
  const P* sp = static_cast<const P*>(scale);
  const P* bp = static_cast<const P*>(bias);
  T* yp = static_cast<T*>(y);
#define LN_CASE(N)                                                     \
  case N:                                                              \
    layernorm_kernel<T, P, N><<<grid, WARPS * 32, 0, st>>>(            \
        xp, sp, bp, yp, mean, rstd, rows, d, eps);                     \
    break;
  switch (nv) {
    LN_CASE(1)
    LN_CASE(2)
    LN_CASE(4)
    LN_CASE(8)
    LN_CASE(16)
    LN_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LN_CASE
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int BW = 8;   // warps a block of the backward

// One block per tile of `tile` consecutive rows; warp w takes rows w, w +
// BW, ... of it.  part: (gridDim.x, 2 d) fp32, this block's row of dscale
// then dbias sums.  red: (BW / 2, 2 d) fp32 of dynamic shared memory.
template <typename T, typename P, int NV>
__global__ void __launch_bounds__(BW * 32)
layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const P* __restrict__ scale,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd, T* __restrict__ dx,
                     float* __restrict__ part, int rows, int d, int tile) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ float red[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * tile, r1 = min(r0 + tile, rows);
  float ds[NV][E], db[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) ds[i][e] = db[i][e] = 0.f;

  for (int row = r0 + warp; row < r1; row += BW) {
    const T* xr = x + (int64_t)row * d;
    const T* gr = dy + (int64_t)row * d;
    const float mu = mean[row], rs = rstd[row];
    float xh[NV][E], g[NV][E];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (i * 32 + lane) * E;
      if (col < d) {
        float gv[E];
        load16(xr + col, xh[i]);
        load16(gr + col, gv);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float h = (xh[i][e] - mu) * rs;
          xh[i][e] = h;
          g[i][e] = gv[e] * to_f(scale[col + e]);
          sg += g[i][e];
          sgx += g[i][e] * h;
          ds[i][e] += gv[e] * h;
          db[i][e] += gv[e];
        }
      }
    }
    const float mg = warp_sum(sg) / d, mgx = warp_sum(sgx) / d;
    T* dxr = dx + (int64_t)row * d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (i * 32 + lane) * E;
      if (col < d) {
        float out[E];
#pragma unroll
        for (int e = 0; e < E; ++e)
          out[e] = rs * (g[i][e] - mg - xh[i][e] * mgx);
        store16(dxr + col, out);
      }
    }
  }

  // the block's sums: warps [h, 2 h) hand theirs to warps [0, h), h = BW /
  // 2, BW / 4, ..., 1 -- one order, whatever the timing
  for (int h = BW / 2; h > 0; h /= 2) {
    if (warp >= h && warp < 2 * h) {
      float* dst = red + (warp - h) * 2 * d;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int col = (i * 32 + lane) * E;
        if (col < d)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            dst[col + e] = ds[i][e];
            dst[d + col + e] = db[i][e];
          }
      }
    }
    __syncthreads();
    if (warp < h) {
      const float* src = red + warp * 2 * d;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int col = (i * 32 + lane) * E;
        if (col < d)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            ds[i][e] += src[col + e];
            db[i][e] += src[d + col + e];
          }
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
    float* dst = part + (int64_t)blockIdx.x * 2 * d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = (i * 32 + lane) * E;
      if (col < d)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          dst[col + e] = ds[i][e];
          dst[d + col + e] = db[i][e];
        }
    }
  }
}

template <typename T, typename P>
int launch_bwd_t(int nv, const void* x, const void* dy, const void* scale,
                 const float* mean, const float* rstd, void* dx,
                 void* dscale, void* dbias, float* part, int rows, int d,
                 int tile, cudaStream_t st) {
  const int n = (rows + tile - 1) / tile;
  const size_t smem = sizeof(float) * (BW / 2) * 2 * d;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(dy);
  const P* sp = static_cast<const P*>(scale);
  T* dxp = static_cast<T*>(dx);
  cudaError_t err;
#define LNB_CASE(N)                                                          \
  case N:                                                                    \
    err = cudaFuncSetAttribute(layernorm_bwd_kernel<T, P, N>,               \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               (int)smem);                                   \
    if (err != cudaSuccess) return (int)err;                                 \
    layernorm_bwd_kernel<T, P, N><<<n, BW * 32, smem, st>>>(                 \
        xp, gp, sp, mean, rstd, dxp, part, rows, d, tile);                   \
    break;
  switch (nv) {
    LNB_CASE(1)
    LNB_CASE(2)
    LNB_CASE(4)
    LNB_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LNB_CASE
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  colsum_kernel<P><<<(2 * d + 31) / 32, 256, 0, st>>>(
      part, n, 2 * d, d, static_cast<P*>(dscale), static_cast<P*>(dbias));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (x and y): 0 = float32, 1 = bfloat16, 2 = float16; param_dtype
// (scale, bias): float32 or x's code.  x and y are contiguous (rows, d)
// with d a multiple of the 16-byte vector (4 floats, 8 16-bit values) and
// 16-byte aligned; nv = 16-byte vectors per lane, a power of two in
// [1, 32] with 32 * nv vectors >= the row.  mean and rstd receive (rows,)
// float32.  Returns cudaGetLastError().
extern "C" int layernorm_fwd(int dtype, int param_dtype, int nv,
                             const void* x, const void* scale,
                             const void* bias, void* y, float* mean,
                             float* rstd, int rows, int d, float eps,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && param_dtype == 0)
    return launch_t<float, float>(nv, x, scale, bias, y, mean, rstd, rows, d,
                                  eps, s);
  if (dtype == 1 && param_dtype == 1)
    return launch_t<__nv_bfloat16, __nv_bfloat16>(nv, x, scale, bias, y,
                                                  mean, rstd, rows, d, eps, s);
  if (dtype == 1 && param_dtype == 0)
    return launch_t<__nv_bfloat16, float>(nv, x, scale, bias, y, mean, rstd,
                                          rows, d, eps, s);
  if (dtype == 2 && param_dtype == 2)
    return launch_t<__half, __half>(nv, x, scale, bias, y, mean, rstd, rows,
                                    d, eps, s);
  if (dtype == 2 && param_dtype == 0)
    return launch_t<__half, float>(nv, x, scale, bias, y, mean, rstd, rows,
                                   d, eps, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: dx (x's dtype and layout), dscale and dbias (scale's dtype,
// (d,)) from x and dy (contiguous (rows, d) of one dtype, 16-byte aligned),
// scale (d,) and the forward's mean and rstd ((rows,) float32).  Codes and
// nv as layernorm_fwd, nv in [1, 8].  tile: rows a block; part: float32
// scratch of (ceil(rows / tile), 2 d).  Two launches; returns the first
// failing one's error.
extern "C" int layernorm_bwd(int dtype, int param_dtype, int nv,
                             const void* x, const void* dy,
                             const void* scale, const float* mean,
                             const float* rstd, void* dx, void* dscale,
                             void* dbias, float* part, int rows, int d,
                             int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile < 1) return (int)cudaErrorInvalidValue;
#define LNB_ARGS nv, x, dy, scale, mean, rstd, dx, dscale, dbias, part, rows, \
                 d, tile, s
  if (dtype == 0 && param_dtype == 0)
    return launch_bwd_t<float, float>(LNB_ARGS);
  if (dtype == 1 && param_dtype == 1)
    return launch_bwd_t<__nv_bfloat16, __nv_bfloat16>(LNB_ARGS);
  if (dtype == 1 && param_dtype == 0)
    return launch_bwd_t<__nv_bfloat16, float>(LNB_ARGS);
  if (dtype == 2 && param_dtype == 2)
    return launch_bwd_t<__half, __half>(LNB_ARGS);
  if (dtype == 2 && param_dtype == 0)
    return launch_bwd_t<__half, float>(LNB_ARGS);
#undef LNB_ARGS
  return (int)cudaErrorInvalidValue;
}
