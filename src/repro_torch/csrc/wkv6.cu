// RWKV-6 chunk recurrence (WKV6) for Hopper (sm_90a), fp32 arithmetic.
//
// Replaces the TPU kernel repro/kernels/wkv6.py:98 `wkv6` / `_wkv6_kernel`
// (:32).  What it computes is the same: per (batch, head), over chunks of
// L <= 64 tokens in order, with c the inclusive cumulative sum of the log
// decay over the chunk and c_prev = c - logw,
//
//   A[i,j] = sum_c r_i[c] k_j[c] e^{c_prev_i[c] - c_j[c]}        (j < i)
//   o_i    = sum_{j<i} A[i,j] v_j + (r_i . (u * k_i)) v_i + (r_i * e^{c_prev_i}) S
//   S     <- diag(e^{c_L}) S + sum_j (k_j * e^{c_L - c_j})^T v_j
//
// Every exponent is an ordered difference of cumulative decays (<= 0), as
// in the reference: no q e^{c} / k e^{-c} factorisation, so a strong decay
// underflows to 0 and never overflows.
//
// Translation.  The TPU kernel runs the chunks as the sequential axis of
// its grid and keeps S in VMEM scratch between grid steps.  Blocks on the
// card run in no order, so one block owns one (b, h) and walks its chunks
// in a loop, with S (64 x 64 fp32, 16 KB) resident in shared memory for the
// whole sequence.  Each chunk's r, k, v and logw are read in place through
// their (B, S, H, hs) strides (no transposed copies), cast to fp32 and
// staged in shared memory; o is written in (B, S, H, hs) layout.  The TPU
// kernel materialises an (L, L, hs) decay tensor (1 MB at L = 64), which
// does not fit in shared memory: here each thread owns score entries
// (i, j) and loops over the channel, one exponential per (i, j, c) of the
// lower triangle; warps whose rows are all at or above the diagonal skip
// the loop.  The three 64-wide products (A V, (r e^{c_prev}) S and the
// state update) are register-tiled 4 x 4 per thread on CUDA cores.  Arrays
// read down a column by a warp have rows padded to 65 floats, so a warp's
// 32 lanes hit 32 banks.  116.5 KB of shared memory: one block per SM.
//
// Bound.  At the serving path's prefill shape (B 4, S 1024, H 32, hs 64,
// bf16 r/k/v, 16 chunks of 64) a launch must move ~122 MB (r, k, v in
// bf16, logw and o in fp32, the two states): 0.036 ms at 3.35 TB/s.  Per
// (chunk, head) the lower-triangle scores take ~0.52 MFLOP and the three
// 64 x 64 x 64 products 1.57 MFLOP (the TPU kernel's full-square form ~2.9
// MFLOP), ~4.6 GFLOP a launch in all plus ~0.28 G exponentials: 0.07 ms on
// fp32 CUDA cores at 67 TFLOP/s, so operations bound it.  This first
// version does not use tensor cores and runs 128 blocks of 8 warps at
// batch 4 (32 at batch 1); splitting S's value columns across blocks, mma
// for the three products and fewer exponentials via sub-chunks are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HS = 64;          // head size
constexpr int LMAX = 64;        // longest chunk
constexpr int PAD = HS + 1;     // padded row of the column-read arrays
constexpr int THREADS = 256;
constexpr int SMEM_FLOATS = 5 * LMAX * PAD + LMAX * HS + HS * HS + 2 * HS;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

struct Strides {   // element strides of the (B, S, H) axes of r, k, v, logw
  int64_t b[4], s[4], h[4];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const T* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ s_final, Strides st,
            int H, int S, int L) {
  extern __shared__ float smem[];
  float* sr = smem;               // [LMAX][PAD] r, then r * e^{c_prev}
  float* sk = sr + LMAX * PAD;    // [LMAX][PAD] k, then k * e^{c_L - c}
  float* sc = sk + LMAX * PAD;    // [LMAX][PAD] c, the inclusive cumsum
  float* scp = sc + LMAX * PAD;   // [LMAX][PAD] logw, then c_prev
  float* sa = scp + LMAX * PAD;   // [LMAX][PAD] scores, bonus on the diagonal
  float* sv = sa + LMAX * PAD;    // [LMAX][HS]  v
  float* ss = sv + LMAX * HS;     // [HS][HS]    the state S
  float* su = ss + HS * HS;       // [HS]        u
  float* sec = su + HS;           // [HS]        e^{c_L}

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;

  const float* s0p = s0 + (int64_t)bh * HS * HS;
  for (int e = tid; e < HS * HS; e += THREADS) ss[e] = s0p[e];
  if (tid < HS) su[tid] = to_f(u[h * HS + tid]);
  const int64_t base_r = b * st.b[0] + h * st.h[0];
  const int64_t base_k = b * st.b[1] + h * st.h[1];
  const int64_t base_v = b * st.b[2] + h * st.h[2];
  const int64_t base_w = b * st.b[3] + h * st.h[3];

  for (int t0 = 0; t0 < S; t0 += L) {
    // stage the chunk in fp32
    for (int e = tid; e < L * HS; e += THREADS) {
      const int i = e / HS, c = e % HS;
      const int64_t t = t0 + i;
      sr[i * PAD + c] = to_f(r[base_r + t * st.s[0] + c]);
      sk[i * PAD + c] = to_f(k[base_k + t * st.s[1] + c]);
      sv[i * HS + c] = to_f(v[base_v + t * st.s[2] + c]);
      scp[i * PAD + c] = logw[base_w + t * st.s[3] + c];
    }
    __syncthreads();
    // cumulative log decay, one channel per thread
    if (tid < HS) {
      float run = 0.f;
      for (int i = 0; i < L; ++i) {
        const float w = scp[i * PAD + tid];
        run += w;
        sc[i * PAD + tid] = run;
        scp[i * PAD + tid] = run - w;
      }
    }
    __syncthreads();
    // scores: this thread's key row j against query rows ig, ig + 4, ...
    {
      const int j = tid % LMAX, ig = tid / LMAX;
      for (int i = ig; i < L; i += THREADS / LMAX) {
        float acc = 0.f;
        if (j < i) {
          const float* ri = sr + i * PAD;
          const float* cpi = scp + i * PAD;
          const float* kj = sk + j * PAD;
          const float* cj = sc + j * PAD;
#pragma unroll 8
          for (int c = 0; c < HS; ++c)
            acc += ri[c] * kj[c] * __expf(cpi[c] - cj[c]);
        } else if (j == i) {
#pragma unroll 8
          for (int c = 0; c < HS; ++c)
            acc += sr[i * PAD + c] * su[c] * sk[j * PAD + c];
        }
        if (j < L) sa[i * PAD + j] = acc;
      }
    }
    __syncthreads();
    // fold the decays into r and k, and e^{c_L}
    for (int e = tid; e < L * HS; e += THREADS) {
      const int i = e / HS, c = e % HS;
      const float cl = sc[(L - 1) * PAD + c];
      sr[i * PAD + c] *= __expf(scp[i * PAD + c]);
      sk[i * PAD + c] *= __expf(cl - sc[i * PAD + c]);
    }
    if (tid < HS) sec[tid] = __expf(sc[(L - 1) * PAD + tid]);
    __syncthreads();
    // o rows r0 .. r0 + 3, value columns n0 .. n0 + 3
    const int r0 = (tid / 16) * 4, n0 = (tid % 16) * 4;
    if (r0 < L) {
      float acc[4][4] = {};
      for (int j = 0; j < L; ++j) {
        const float4 vj = *reinterpret_cast<const float4*>(sv + j * HS + n0);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float x = sa[(r0 + a) * PAD + j];
          acc[a][0] += x * vj.x;
          acc[a][1] += x * vj.y;
          acc[a][2] += x * vj.z;
          acc[a][3] += x * vj.w;
        }
      }
      for (int c = 0; c < HS; ++c) {
        const float4 sc4 = *reinterpret_cast<const float4*>(ss + c * HS + n0);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float x = sr[(r0 + a) * PAD + c];
          acc[a][0] += x * sc4.x;
          acc[a][1] += x * sc4.y;
          acc[a][2] += x * sc4.z;
          acc[a][3] += x * sc4.w;
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (r0 + a >= L) break;   // a chunk of L % 4 != 0 rows
        const int64_t t = t0 + r0 + a;
        *reinterpret_cast<float4*>(o + ((b * (int64_t)S + t) * H + h) * HS +
                                   n0) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
    }
    __syncthreads();   // every read of the old S is done
    // S rows r0 .. r0 + 3 (key channels), value columns n0 .. n0 + 3
    {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float e = sec[r0 + a];
        const float4 s4 = *reinterpret_cast<const float4*>(ss + (r0 + a) * HS +
                                                           n0);
        acc[a][0] = e * s4.x;
        acc[a][1] = e * s4.y;
        acc[a][2] = e * s4.z;
        acc[a][3] = e * s4.w;
      }
      for (int j = 0; j < L; ++j) {
        const float4 vj = *reinterpret_cast<const float4*>(sv + j * HS + n0);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float x = sk[j * PAD + r0 + a];
          acc[a][0] += x * vj.x;
          acc[a][1] += x * vj.y;
          acc[a][2] += x * vj.z;
          acc[a][3] += x * vj.w;
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(ss + (r0 + a) * HS + n0) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
    __syncthreads();   // the next chunk overwrites the staged arrays
  }
  float* sfp = s_final + (int64_t)bh * HS * HS;
  for (int e = tid; e < HS * HS; e += THREADS) sfp[e] = ss[e];
}

template <typename T>
int launch_t(const void* r, const void* k, const void* v, const float* logw,
             const void* u, const float* s0, float* o, float* s_final,
             const Strides& st, int B, int H, int S, int L,
             cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<T><<<B * H, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, static_cast<const T*>(u), s0, o,
      s_final, st, H, S, L);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (r, k, v and u): 0 = float32, 1 = bfloat16.  r, k, v, logw:
// (B, S, H, 64) with a contiguous last dim, element strides of their B, S
// and H axes in `strides` (host memory: the B strides of r, k, v, logw,
// then their S strides, then their H strides); logw float32.  u: (H, 64)
// contiguous; s0: (B, H, 64, 64) contiguous float32.  o receives
// (B, S, H, 64) contiguous float32, s_final (B, H, 64, 64) float32.  L (the
// chunk) is in [1, 64] and divides S.  Returns cudaGetLastError().
extern "C" int wkv6_fwd(int dtype, const void* r, const void* k,
                        const void* v, const float* logw, const void* u,
                        const float* s0, float* o, float* s_final,
                        const int64_t* strides, int B, int H, int S, int L,
                        void* stream) {
  if (L < 1 || L > LMAX || S % L != 0 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.b[i] = strides[i];
    st.s[i] = strides[4 + i];
    st.h[i] = strides[8 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(r, k, v, logw, u, s0, o, s_final, st, B, H, S, L,
                           s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(r, k, v, logw, u, s0, o, s_final, st, B,
                                   H, S, L, s);
  return (int)cudaErrorInvalidValue;
}
