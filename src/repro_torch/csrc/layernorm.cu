// Row LayerNorm forward for Hopper (sm_90a), fp32 statistics.
//
// Replaces the TPU kernel repro/kernels/layernorm.py:40 `layernorm` /
// `_layernorm_kernel` (:16).  What it computes is the same: per row of d
// values, mean and variance in fp32 (the variance as the mean of squared
// deviations, two passes over the row, as jnp.var), y = (x - mean) *
// rsqrt(var + eps) * scale + bias, y in x's dtype.  It also writes each
// row's mean and rstd (fp32) for the backward, which the JAX package leaves
// to XLA's autodiff and the port computes in PyTorch from these.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes: 4 floats or 8 bf16
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x;
  out[1] = t.y;
  out[2] = t.z;
  out[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&t);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void store16(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* in) {
  uint4 t;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&t);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(in[i]);
  *reinterpret_cast<uint4*>(p) = t;
}

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

}  // namespace

// dtype (x and y): 0 = float32, 1 = bfloat16; param_dtype (scale, bias):
// the same codes.  x and y are contiguous (rows, d) with d a multiple of
// the 16-byte vector (4 floats, 8 bf16) and 16-byte aligned; nv = 16-byte
// vectors per lane, a power of two in [1, 32] with 32 * nv vectors >= the
// row.  mean and rstd receive (rows,) float32.  Returns cudaGetLastError().
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
  return (int)cudaErrorInvalidValue;
}
