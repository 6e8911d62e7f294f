// Fused LAMB moment update for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel repro/kernels/lamb_update.py:49 `lamb_moments` /
// `_lamb_kernel` (:17), the elementwise part of APEX's fused LAMB (paper
// §4.3).  Per element of one parameter leaf:
//   m' = b1 m + (1 - b1) g          v' = b2 v + (1 - b2) g^2
//   update = (m' c1) / (sqrt(v' c2) + eps) + wd w
// with the bias corrections passed in as the TPU kernel's `corr` pair,
// c1 = 1 / (1 - b1^t) and c2 = 1 / (1 - b2^t).  The trust-ratio norms
// ||w|| and ||update|| are reductions over the whole leaf and stay outside
// the kernel, as in the reference.
//
// Translation.  The TPU kernel walks 64K-element blocks of the flattened
// leaf, one per grid step.  Here a grid-stride loop of float4 vectors covers
// the leaf (neighbouring threads on neighbouring addresses), with a scalar
// tail when the leaf's length is not a multiple of 4.
//
// Bound.  ~15 FLOP per element against 28 bytes (w, g, m, v read; m', v',
// update written): bytes bound it.  BERT-large's ~336 M parameters move
// 9.4 GB a step, 2.8 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd, c1, c2;
};

__device__ __forceinline__ void step(float w, float g, float m, float v,
                                     const Hyper& p, float* m2, float* v2,
                                     float* u) {
  *m2 = p.b1 * m + p.omb1 * g;
  *v2 = p.b2 * v + p.omb2 * g * g;
  *u = (*m2 * p.c1) / (sqrtf(*v2 * p.c2) + p.eps) + p.wd * w;
}

__global__ void __launch_bounds__(THREADS)
lamb_kernel(const float* __restrict__ w, const float* __restrict__ g,
            const float* __restrict__ m, const float* __restrict__ v,
            float* __restrict__ m_out, float* __restrict__ v_out,
            float* __restrict__ upd, int64_t n, Hyper p) {
  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = blockIdx.x * (int64_t)THREADS + threadIdx.x; i < n4;
       i += stride) {
    const float4 wv = reinterpret_cast<const float4*>(w)[i];
    const float4 gv = reinterpret_cast<const float4*>(g)[i];
    const float4 mv = reinterpret_cast<const float4*>(m)[i];
    const float4 vv = reinterpret_cast<const float4*>(v)[i];
    float4 mo, vo, uo;
    step(wv.x, gv.x, mv.x, vv.x, p, &mo.x, &vo.x, &uo.x);
    step(wv.y, gv.y, mv.y, vv.y, p, &mo.y, &vo.y, &uo.y);
    step(wv.z, gv.z, mv.z, vv.z, p, &mo.z, &vo.z, &uo.z);
    step(wv.w, gv.w, mv.w, vv.w, p, &mo.w, &vo.w, &uo.w);
    reinterpret_cast<float4*>(m_out)[i] = mo;
    reinterpret_cast<float4*>(v_out)[i] = vo;
    reinterpret_cast<float4*>(upd)[i] = uo;
  }
  // tail: the last n % 4 elements
  const int64_t t = n4 * 4 + blockIdx.x * (int64_t)THREADS + threadIdx.x;
  if (t < n) step(w[t], g[t], m[t], v[t], p, m_out + t, v_out + t, upd + t);
}

}  // namespace

// w, g, m, v, m_out, v_out, upd: n contiguous float32 each, 16-byte
// aligned.  omb1 = 1 - b1 and omb2 = 1 - b2 as float32; c1, c2 the bias
// corrections 1 / (1 - b^t).  Returns cudaGetLastError().
extern "C" int lamb_moments(const float* w, const float* g, const float* m,
                            const float* v, float* m_out, float* v_out,
                            float* upd, int64_t n, float b1, float omb1,
                            float b2, float omb2, float eps, float wd,
                            float c1, float c2, void* stream) {
  const int64_t n4 = n / 4;
  int64_t blocks = (n4 + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks == 0) blocks = 1;
  const Hyper p{b1, omb1, b2, omb2, eps, wd, c1, c2};
  lamb_kernel<<<(int)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      w, g, m, v, m_out, v_out, upd, n, p);
  return (int)cudaGetLastError();
}
