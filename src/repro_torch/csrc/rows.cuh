// Row helpers shared by the LayerNorm (layernorm.cu) and bias-GELU
// (bias_gelu.cu) kernels: 16-byte vector loads that widen float32,
// bfloat16 or float16 to fp32 and stores that round back once, the
// asynchronous copies (cp.async) that fill a warp's ring of rows in shared
// memory, and the fixed-order column sum of per-tile fp32 partials that
// both backwards end with.  kernels/build.py hashes it into each library's name and passes
// nvcc the -I of this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// a float rounded to nearest in T (past the f16 range: inf, which the
// loss scale must see)
template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same<T, __half>::value)
    return __float2half_rn(x);
  else if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn(x);
  else
    return x;
}

// 16 bytes: 4 floats or 8 16-bit values
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x;
  out[1] = t.y;
  out[2] = t.z;
  out[3] = t.w;
}
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&t);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = to_f(e[i]);
}
__device__ __forceinline__ void store16(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
template <typename T>
__device__ __forceinline__ void store16(T* p, const float* in) {
  uint4 t;
  T* e = reinterpret_cast<T*>(&t);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = from_f<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = t;
}

// E values of P from 16-byte aligned p, as 16-byte vectors (one, or two
// for float parameters beside 16-bit rows), widened to fp32
template <int E, typename P>
__device__ __forceinline__ void load_vals(const P* p, float* out) {
  constexpr int PER = 16 / sizeof(P);
#pragma unroll
  for (int c = 0; c < E / PER; ++c) load16(p + c * PER, out + c * PER);
}

// asynchronous global -> shared copies.  A lane that waits sees its own
// copies; another lane's only after a barrier.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n (0, 1 or 2) of this lane's latest groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// out[c] = sum over p < n of part[p][c], c < cols, in one order whatever
// the timing: warp w adds rows p = w, w + 8, ... in turn, then warp 0 adds
// the eight warps' sums in order.  Columns [0, split) go to out0,
// [split, cols) to out1, rounded to P.  Blocks of 256 threads, 32 columns
// each.
template <typename P>
__global__ void __launch_bounds__(256)
colsum_kernel(const float* __restrict__ part, int n, int cols, int split,
              P* __restrict__ out0, P* __restrict__ out1) {
  __shared__ float red[8][33];
  // launched as a programmatic dependent of the kernel that writes `part`:
  // wait until that kernel has finished and its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < cols)
    for (int p = warp; p < n; p += 8) acc += part[(int64_t)p * cols + c];
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < cols) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[w][lane];
    if (c < split)
      out0[c] = from_f<P>(s);
    else
      out1[c - split] = from_f<P>(s);
  }
}

}  // namespace
