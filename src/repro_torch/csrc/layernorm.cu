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
// per grid step.  Here one warp owns a row at a time and streams several
// rows through a ring of up to three rows in shared memory: while it
// reduces and stores one row, the next rows' bytes are in flight (16-byte
// cp.async copies, neighbouring lanes on neighbouring addresses).  Each
// lane copies, and later reads, only its own 16-byte vectors of a row, so
// a lane's own wait is all the ring needs: no barrier in the row loop.  The
// row is read from shared memory once a pass (the sum, the squared
// deviations, the output) and never held in registers; scale and bias are
// copied to shared memory once a block, as 16-byte vectors, and read there
// for every row.  Four warps a block; the wrapper gives each warp the same
// number of consecutive rows, sized from the row count alone so that the
// grid is about one wave of four blocks an SM on the 132 SMs of an H100
// (kernels/layernorm.py `fwd_plan`).
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
// A block (8 warps) owns a tile of consecutive rows, each warp the same
// number of consecutive rows of it.  x and dy stream through a warp's ring
// as in the forward (the row's mean and rstd copied beside them, so no
// load waits in the loop); the first pass over the row in shared memory
// takes the two row sums and adds dy xhat and dy into the lane's dscale and
// dbias sums (registers, over the warp's rows), the second reads x and dy
// again to write dx.  The block adds its warps' sums in warp order through
// shared memory and writes one fp32 partial row of 2 d values for its
// tile; a second small pass (colsum_kernel, rows.cuh) adds the tiles'
// partials column by column, in tile order.  It is launched as a
// programmatic dependent of the main kernel, so its launch overlaps the
// main kernel and it waits on the card for the partials.  (A ticket
// electing the last block to add the partials would leave one SM to read
// them all, 1 MB at phase 1.)  No floating-point atomics:
// the gradients are bit-identical from run to run.  The tiles are a
// function of the row count alone (kernels/layernorm.py `bwd_tiles`: about
// one wave of one block an SM), so the order of every sum is too.  At most
// 128 registers a thread for rows of up to 4 vectors a lane (d 1024 in 16
// bits), so two blocks would fit an SM; one block with twice the rows a
// warp measured faster.
//
// Its bound: x and dy read, dx written (6 bytes an element in bf16), ~13
// FLOP an element: bytes again.  At phase 2 (16384 x 1024 bf16) 100.7 MB,
// 30 us at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "rows.cuh"

namespace {

constexpr int FW = 4;          // warps a block of the forward
constexpr int BW = 8;          // warps a block of the backward
constexpr int STAGES = 3;      // rows in a warp's ring, at most
constexpr int64_t SMEM_MAX = 232448;  // shared memory a block may have

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// dst[0, n) = src[0, n) by the block's threads: 16-byte vectors where src
// is 16-byte aligned (n * sizeof(P) is a multiple of 16), else elements
template <typename P>
__device__ __forceinline__ void params_to_smem(P* dst, const P* src, int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int v = threadIdx.x; v < n * (int)sizeof(P) / 16; v += blockDim.x)
      d[v] = s[v];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// a lane's 16-byte vectors c = lane, lane + 32, ... < nvec of a row
template <int NV>
__device__ __forceinline__ void copy_row(unsigned char* dst,
                                         const unsigned char* src, int nvec,
                                         int lane) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * 32 + lane;
    if (c < nvec) cp_async16(dst + c * 16, src + (int64_t)c * 16);
  }
}

// NV: 16-byte vectors per lane (the row holds at most 32 * NV of them).
// Warp w of block b takes rows [(b FW + w) rpw, + rpw); its ring holds
// `stages` rows.  Shared memory: scale and bias (d P each), then the rings.
template <typename T, typename P, int NV>
__global__ void __launch_bounds__(FW * 32)
layernorm_kernel(const T* __restrict__ x, const P* __restrict__ scale,
                 const P* __restrict__ bias, T* __restrict__ y,
                 float* __restrict__ mean_out, float* __restrict__ rstd_out,
                 int rows, int d, float eps, int rpw, int stages) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nvec = d / E;
  const int64_t rowb = (int64_t)d * sizeof(T);
  P* s_scale = reinterpret_cast<P*>(smem);
  P* s_bias = s_scale + d;
  unsigned char* ring =
      smem + 2 * (int64_t)d * sizeof(P) + warp * stages * rowb;
  const int r0 = (blockIdx.x * FW + warp) * rpw;
  const int n = max(0, min(rpw, rows - r0));
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);

  // the ring's first rows, then the parameters (once a block)
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n)
      copy_row<NV>(ring + s * rowb, xb + (r0 + s) * rowb, nvec, lane);
    cp_async_commit();
  }
  params_to_smem(s_scale, scale, d);
  params_to_smem(s_bias, bias, d);
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const int next = k + stages - 1;
    if (next < n)
      copy_row<NV>(ring + (next % stages) * rowb, xb + (r0 + next) * rowb,
                   nvec, lane);
    cp_async_commit();
    cp_async_wait(stages - 1);  // row k's copies, this lane's own
    const T* xr = reinterpret_cast<const T*>(ring + (k % stages) * rowb);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * 32 + lane;
      if (c < nvec) {
        float v[E];
        load16(xr + c * E, v);
#pragma unroll
        for (int e = 0; e < E; ++e) sum += v[e];
      }
    }
    const float mean = warp_sum(sum) / d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * 32 + lane;
      if (c < nvec) {
        float v[E];
        load16(xr + c * E, v);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float dev = v[e] - mean;
          sq += dev * dev;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / d + eps);
    T* yr = y + (int64_t)(r0 + k) * d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * 32 + lane;
      if (c < nvec) {
        float v[E], sc[E], bi[E], out[E];
        load16(xr + c * E, v);
        load_vals<E>(s_scale + c * E, sc);
        load_vals<E>(s_bias + c * E, bi);
#pragma unroll
        for (int e = 0; e < E; ++e)
          out[e] = (v[e] - mean) * rstd * sc[e] + bi[e];
        store16(yr + c * E, out);
      }
    }
    if (lane == 0) {
      mean_out[r0 + k] = mean;
      rstd_out[r0 + k] = rstd;
    }
  }
}

template <typename T, typename P>
int launch_t(int nv, const void* x, const void* scale, const void* bias,
             void* y, float* mean, float* rstd, int rows, int d, float eps,
             int rpw, cudaStream_t st) {
  if (rpw < 1) return (int)cudaErrorInvalidValue;
  const int64_t rowb = (int64_t)d * sizeof(T);
  const int64_t pbytes = 2 * (int64_t)d * sizeof(P);
  int stages = std::min(STAGES, rpw);
  while (stages > 1 && pbytes + FW * stages * rowb > SMEM_MAX) --stages;
  const int64_t smem = pbytes + FW * stages * rowb;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  void (*kern)(const T*, const P*, const P*, T*, float*, float*, int, int,
               float, int, int) = nullptr;
  switch (nv) {
    case 1: kern = layernorm_kernel<T, P, 1>; break;
    case 2: kern = layernorm_kernel<T, P, 2>; break;
    case 4: kern = layernorm_kernel<T, P, 4>; break;
    case 8: kern = layernorm_kernel<T, P, 8>; break;
    case 16: kern = layernorm_kernel<T, P, 16>; break;
    case 32: kern = layernorm_kernel<T, P, 32>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int warps = (rows + rpw - 1) / rpw;
  kern<<<(warps + FW - 1) / FW, FW * 32, smem, st>>>(
      static_cast<const T*>(x), static_cast<const P*>(scale),
      static_cast<const P*>(bias), static_cast<T*>(y), mean, rstd, rows, d,
      eps, rpw, stages);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// One block per tile of BW * rpw consecutive rows; warp w takes rows [w rpw,
// (w + 1) rpw) of it.  part: (gridDim.x, 2 d) fp32, this block's row of
// dscale then dbias sums.  Shared memory: scale (d P, padded to 16 bytes),
// then the rings, each stage an x row, a dy row and the row's mean and rstd
// (16 bytes); after the row loop the rings' bytes hold the warps' sums
// (BW rows of 2 d floats).
template <typename T, typename P, int NV>
__global__ void __launch_bounds__(BW * 32, NV <= 4 ? 2 : 1)
layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const P* __restrict__ scale,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd, T* __restrict__ dx,
                     float* __restrict__ part, int rows, int d, int rpw,
                     int stages) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nvec = d / E;
  const int64_t rowb = (int64_t)d * sizeof(T);
  const int64_t stageb = 2 * rowb + 16;
  P* s_scale = reinterpret_cast<P*>(smem);
  unsigned char* rings = smem + ((d * (int64_t)sizeof(P) + 15) / 16) * 16;
  unsigned char* ring = rings + warp * stages * stageb;
  const int r0 = (blockIdx.x * BW + warp) * rpw;
  const int n = max(0, min(rpw, rows - r0));
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const unsigned char* gb = reinterpret_cast<const unsigned char*>(dy);
  // let the column sum launch now: it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // row r0 + k into its stage: x, dy, then mean and rstd (lanes 0 and 1)
  auto copy = [&](int k) {
    unsigned char* st = ring + (k % stages) * stageb;
    const int64_t off = (r0 + k) * rowb;
    copy_row<NV>(st, xb + off, nvec, lane);
    copy_row<NV>(st + rowb, gb + off, nvec, lane);
    if (lane == 0) cp_async4(st + 2 * rowb, mean + r0 + k);
    if (lane == 1) cp_async4(st + 2 * rowb + 4, rstd + r0 + k);
  };
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n) copy(s);
    cp_async_commit();
  }
  params_to_smem(s_scale, scale, d);
  __syncthreads();

  float ds[NV][E], db[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) ds[i][e] = db[i][e] = 0.f;

  for (int k = 0; k < n; ++k) {
    if (k + stages - 1 < n) copy(k + stages - 1);
    cp_async_commit();
    cp_async_wait(stages - 1);
    // lanes 0 and 1 copied mean and rstd: the barrier shows them to the
    // warp.  (The stage is refilled only after the warp's sums below, which
    // every lane reaches after reading them.)
    __syncwarp();
    const unsigned char* st = ring + (k % stages) * stageb;
    const T* xr = reinterpret_cast<const T*>(st);
    const T* gr = reinterpret_cast<const T*>(st + rowb);
    const float mu = reinterpret_cast<const float*>(st + 2 * rowb)[0];
    const float rs = reinterpret_cast<const float*>(st + 2 * rowb)[1];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * 32 + lane;
      if (c < nvec) {
        float xv[E], gv[E], sc[E];
        load16(xr + c * E, xv);
        load16(gr + c * E, gv);
        load_vals<E>(s_scale + c * E, sc);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float h = (xv[e] - mu) * rs;
          const float g = gv[e] * sc[e];
          sg += g;
          sgx += g * h;
          ds[i][e] += gv[e] * h;
          db[i][e] += gv[e];
        }
      }
    }
    const float mg = warp_sum(sg) / d, mgx = warp_sum(sgx) / d;
    T* dxr = dx + (int64_t)(r0 + k) * d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * 32 + lane;
      if (c < nvec) {
        float xv[E], gv[E], sc[E], out[E];
        load16(xr + c * E, xv);
        load16(gr + c * E, gv);
        load_vals<E>(s_scale + c * E, sc);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float h = (xv[e] - mu) * rs;
          const float g = gv[e] * sc[e];
          out[e] = rs * (g - mg - h * mgx);
        }
        store16(dxr + c * E, out);
      }
    }
  }

  // every warp done with its ring: the warps' sums reuse the rings' bytes
  cp_async_wait(0);
  __syncthreads();
  float* red = reinterpret_cast<float*>(rings);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * 32 + lane;
    if (c < nvec)
#pragma unroll
      for (int q = 0; q < E; q += 4) {
        store16(red + warp * 2 * d + c * E + q, &ds[i][q]);
        store16(red + warp * 2 * d + d + c * E + q, &db[i][q]);
      }
  }
  __syncthreads();
  // the block's partial row: each 16-byte column vector the sum of the
  // warps' in warp order -- one order, whatever the timing
  float* dst = part + (int64_t)blockIdx.x * 2 * d;
  for (int v = threadIdx.x; v < 2 * d / 4; v += BW * 32) {
    float acc[4], t[4];
    load16(red + 4 * v, acc);
    for (int w = 1; w < BW; ++w) {
      load16(red + w * 2 * d + 4 * v, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += t[e];
    }
    store16(dst + 4 * v, acc);
  }
}

template <typename T, typename P>
int launch_bwd_t(int nv, const void* x, const void* dy, const void* scale,
                 const float* mean, const float* rstd, void* dx,
                 void* dscale, void* dbias, float* part, int rows, int d,
                 int tile, cudaStream_t st) {
  if (tile < BW || tile % BW) return (int)cudaErrorInvalidValue;
  const int rpw = tile / BW, n = (rows + tile - 1) / tile;
  const int64_t rowb = (int64_t)d * sizeof(T), stageb = 2 * rowb + 16;
  const int64_t pbytes = ((d * (int64_t)sizeof(P) + 15) / 16) * 16;
  const int64_t sums = BW * 2 * (int64_t)d * sizeof(float);
  int stages = std::min(STAGES, rpw);
  while (stages > 1 &&
         pbytes + std::max<int64_t>(BW * stages * stageb, sums) > SMEM_MAX)
    --stages;
  const int64_t smem = pbytes + std::max<int64_t>(BW * stages * stageb, sums);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  void (*kern)(const T*, const T*, const P*, const float*, const float*, T*,
               float*, int, int, int, int) = nullptr;
  switch (nv) {
    case 1: kern = layernorm_bwd_kernel<T, P, 1>; break;
    case 2: kern = layernorm_bwd_kernel<T, P, 2>; break;
    case 4: kern = layernorm_bwd_kernel<T, P, 4>; break;
    case 8: kern = layernorm_bwd_kernel<T, P, 8>; break;
    // f32 rows of 2048 (rwkv's d_model): 128 fp32 sums a lane; a 16-bit
    // instance would hold 256, past a thread's registers
    case 16:
      if constexpr (sizeof(T) == 4) kern = layernorm_bwd_kernel<T, P, 16>;
      break;
    default: break;
  }
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<n, BW * 32, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const P*>(scale), mean, rstd, static_cast<T*>(dx), part,
      rows, d, rpw, stages);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // the column sum may launch while the main kernel runs: it waits for
  // the main kernel's partials (programmatic dependent launch)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((2 * d + 31) / 32);
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, colsum_kernel<P>,
                                 static_cast<const float*>(part), n, 2 * d,
                                 d, static_cast<P*>(dscale),
                                 static_cast<P*>(dbias));
}

}  // namespace

// dtype (x and y): 0 = float32, 1 = bfloat16, 2 = float16; param_dtype
// (scale, bias): float32 or x's code.  x and y are contiguous (rows, d)
// with d a multiple of the 16-byte vector (4 floats, 8 16-bit values) and
// 16-byte aligned; nv = 16-byte vectors per lane, a power of two in
// [1, 32] with 32 * nv vectors >= the row; rpw = rows a warp (>= 1).  mean
// and rstd receive (rows,) float32.  Returns cudaGetLastError().
extern "C" int layernorm_fwd(int dtype, int param_dtype, int nv,
                             const void* x, const void* scale,
                             const void* bias, void* y, float* mean,
                             float* rstd, int rows, int d, float eps, int rpw,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LN_ARGS nv, x, scale, bias, y, mean, rstd, rows, d, eps, rpw, s
  if (dtype == 0 && param_dtype == 0)
    return launch_t<float, float>(LN_ARGS);
  if (dtype == 1 && param_dtype == 1)
    return launch_t<__nv_bfloat16, __nv_bfloat16>(LN_ARGS);
  if (dtype == 1 && param_dtype == 0)
    return launch_t<__nv_bfloat16, float>(LN_ARGS);
  if (dtype == 2 && param_dtype == 2)
    return launch_t<__half, __half>(LN_ARGS);
  if (dtype == 2 && param_dtype == 0)
    return launch_t<__half, float>(LN_ARGS);
#undef LN_ARGS
  return (int)cudaErrorInvalidValue;
}

// The backward: dx (x's dtype and layout), dscale and dbias (scale's dtype,
// (d,)) from x and dy (contiguous (rows, d) of one dtype, 16-byte aligned),
// scale (d,) and the forward's mean and rstd ((rows,) float32).  Codes and
// nv as layernorm_fwd, nv in [1, 8], or 16 for float32 (rows of at most
// 2048 values in every dtype).  tile: rows a block, a multiple of 8
// (the block's warps); part: float32 scratch of (ceil(rows / tile), 2 d).
// Two launches; returns the first failing one's error.
extern "C" int layernorm_bwd(int dtype, int param_dtype, int nv,
                             const void* x, const void* dy,
                             const void* scale, const float* mean,
                             const float* rstd, void* dx, void* dscale,
                             void* dbias, float* part, int rows, int d,
                             int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
