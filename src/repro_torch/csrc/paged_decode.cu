// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:105
// `paged_decode_attention` / `_paged_kernel` (:56): one new query token per
// slot attends over that slot's kv_len cached tokens, which live in a global
// page pool (P, page_size, KV, Dh) addressed through block_table[b, p].
// Same semantics: page ids are clamped to [0, P-1], the walk stops at
// ceil(kv_len / page_size) pages and the tail page is masked per token, int8
// pages are dequantised with the per-(page, kv-head) scale on load, the tanh
// softcap is applied to the scaled logits, and a slot with kv_len == 0
// writes zeros.
//
// Translation.  On the TPU the page walk is a sequential grid axis and the
// block table rides in as scalar prefetch.  Here one thread block owns one
// (slot, KV head) and computes that head's G = H / KV query rows; the block
// reads its own block_table row and kv_len.  Its 16 warps split the slot's
// pages (warp w takes pages w, w + 16, ...), each keeping its own online
// softmax state (m, l, acc) in registers, and the warps' partial states are
// merged through shared memory at the end -- pages are independent, so a
// split over warps keeps more loads in flight than one sequential walk.
// The pool is read in its (P, page_size, KV, Dh) layout through strides;
// the Pallas wrapper's moveaxis copy of the whole pool is not carried over.
//
// Bound.  Decode attention reads every live K and V byte once and does
// ~4 operations per element: bytes bound it (kv_len * KV * Dh * 2 * itemsize
// per slot at 3.35 TB/s).  Each lane loads Dh / 32 contiguous elements of a
// token row (8 bytes for bf16 at Dh = 128, a 256-byte row per warp), four
// tokens' K and V are loaded before they are used, and int8 pages halve the
// bytes moved against bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 16;  // warps per block
constexpr int TPC = 4;  // tokens loaded per chunk

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

// VEC contiguous elements -> fp32 (VEC is 2 or 4; the wrapper checks the
// alignment these vector loads need)
template <typename T, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
};
template <>
struct Vec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  }
};
template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
};
template <>
struct Vec<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = a.x; o[1] = a.y;
  }
};
template <>
struct Vec<int8_t, 4> {
  static __device__ __forceinline__ void load(const int8_t* p, float* o) {
    const char4 x = *reinterpret_cast<const char4*>(p);
    o[0] = (float)x.x; o[1] = (float)x.y; o[2] = (float)x.z; o[3] = (float)x.w;
  }
};
template <>
struct Vec<int8_t, 2> {
  static __device__ __forceinline__ void load(const int8_t* p, float* o) {
    const char2 x = *reinterpret_cast<const char2*>(p);
    o[0] = (float)x.x; o[1] = (float)x.y;
  }
};

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ks;  // null unless int8 pages
  const float* vs;
  const int* bt;
  const int* kv_len;
  void* out;
  int64_t q_sb, q_sh;        // q (B, H, Dh)
  int64_t k_sp, k_st, k_sh;  // k pages (P, ps, KV, Dh)
  int64_t v_sp, v_st, v_sh;
  int64_t s_sp, s_sh;        // scales (P, KV)
  int64_t bt_sb;             // block table (B, mp)
  int64_t o_sb, o_sh;        // out (B, H, Dh)
  int KV, P, ps, mp;
  float softcap, scale;
};

template <typename QT, typename PT, int G, int D>
__global__ void __launch_bounds__(NW * 32) paged_decode_kernel(Args a) {
  constexpr int VEC = D / 32;
  constexpr bool kQuant = sizeof(PT) == 1;
  extern __shared__ float smem[];
  float* sm_m = smem;                 // NW x G
  float* sm_l = sm_m + NW * G;        // NW x G
  float* sm_acc = sm_l + NW * G;      // NW x G x D

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cap = a.mp * a.ps;
  const int len = min(max(a.kv_len[b], 0), cap);
  const int n_pages = (len + a.ps - 1) / a.ps;

  const QT* qb = static_cast<const QT*>(a.q) + b * a.q_sb;
  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qr[g][e] = to_f(qb[(int64_t)(kvh * G + g) * a.q_sh + lane * VEC + e]) *
                 a.scale;

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const PT* kpool = static_cast<const PT*>(a.kp);
  const PT* vpool = static_cast<const PT*>(a.vp);
  for (int p = warp; p < n_pages; p += NW) {
    const int pid = min(max(a.bt[b * a.bt_sb + p], 0), a.P - 1);
    float ksc = 1.f, vsc = 1.f;
    if (kQuant) {
      ksc = a.ks[pid * a.s_sp + kvh * a.s_sh];
      vsc = a.vs[pid * a.s_sp + kvh * a.s_sh];
    }
    const PT* kpage = kpool + pid * a.k_sp + kvh * a.k_sh + lane * VEC;
    const PT* vpage = vpool + pid * a.v_sp + kvh * a.v_sh + lane * VEC;
    const int tmax = min(a.ps, len - p * a.ps);  // tail-page mask
    for (int t0 = 0; t0 < tmax; t0 += TPC) {
      float kk[TPC][VEC], vv[TPC][VEC];
#pragma unroll
      for (int u = 0; u < TPC; ++u) {
        if (t0 + u < tmax) {
          Vec<PT, VEC>::load(kpage + (t0 + u) * a.k_st, kk[u]);
          Vec<PT, VEC>::load(vpage + (t0 + u) * a.v_st, vv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < TPC; ++u) {
        if (t0 + u >= tmax) break;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) s = fmaf(qr[g][e], kk[u][e] * ksc, s);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
          const float m_new = fmaxf(m[g], s);
          const float corr = expf(m[g] - m_new);
          const float pr = expf(s - m_new);
          l[g] = l[g] * corr + pr;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][e] = fmaf(pr, vv[u][e] * vsc, acc[g][e] * corr);
          m[g] = m_new;
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      sm_acc[(warp * G + g) * D + lane * VEC + e] = acc[g][e];
  }
  __syncthreads();
  QT* ob = static_cast<QT*>(a.out) + b * a.o_sb;
  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
    for (int w = 0; w < NW; ++w)
      if (sm_l[w * G + g] > 0.f) mx = fmaxf(mx, sm_m[w * G + g]);
    float lsum = 0.f, osum = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float lw = sm_l[w * G + g];
      if (lw > 0.f) {
        const float f = expf(sm_m[w * G + g] - mx);
        lsum += lw * f;
        osum += sm_acc[(w * G + g) * D + d] * f;
      }
    }
    ob[(int64_t)(kvh * G + g) * a.o_sh + d] =
        from_f<QT>(osum / fmaxf(lsum, 1e-30f));  // kv_len == 0 -> 0
  }
}

template <typename QT, typename PT, int G, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  auto kern = paged_decode_kernel<QT, PT, G, D>;
  const size_t smem = sizeof(float) * NW * G * (2 + D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.KV, B), NW * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename QT, typename PT, int G>
int launch_d(const Args& a, int D, int B, cudaStream_t s) {
  switch (D) {
    case 64: return launch<QT, PT, G, 64>(a, B, s);
    case 128: return launch<QT, PT, G, 128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename QT, typename PT>
int launch_g(const Args& a, int G, int D, int B, cudaStream_t s) {
  switch (G) {
    case 1: return launch_d<QT, PT, 1>(a, D, B, s);
    case 2: return launch_d<QT, PT, 2>(a, D, B, s);
    case 4: return launch_d<QT, PT, 4>(a, D, B, s);
    case 8: return launch_d<QT, PT, 8>(a, D, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16.  page_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (then k_scale / v_scale are (P, KV) float32).
// strides (13 int64 values, in elements):
//   q (b, h); k pages (page, token, head); v pages (page, token, head);
//   scales (page, head); block table (b); out (b, h).
// The head dim of q, pages and out is contiguous.  block_table (B, mp) and kv_len (B,) are int32.
// Returns cudaGetLastError() after the launch.
extern "C" int paged_decode(int q_dtype, int page_dtype, int G, int D,
                            const void* q, const void* kp, const void* vp,
                            const float* ks, const float* vs, const int* bt,
                            const int* kv_len, void* out,
                            const int64_t* st, int B, int KV, int P, int ps,
                            int mp, float softcap, float scale,
                            void* stream) {
  Args a;
  a.q = q; a.kp = kp; a.vp = vp; a.ks = ks; a.vs = vs; a.bt = bt;
  a.kv_len = kv_len; a.out = out;
  a.q_sb = st[0]; a.q_sh = st[1];
  a.k_sp = st[2]; a.k_st = st[3]; a.k_sh = st[4];
  a.v_sp = st[5]; a.v_st = st[6]; a.v_sh = st[7];
  a.s_sp = st[8]; a.s_sh = st[9];
  a.bt_sb = st[10];
  a.o_sb = st[11]; a.o_sh = st[12];
  a.KV = KV; a.P = P; a.ps = ps; a.mp = mp;
  a.softcap = softcap; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && page_dtype == 0) return launch_g<float, float>(a, G, D, B, s);
  if (q_dtype == 1 && page_dtype == 1)
    return launch_g<__nv_bfloat16, __nv_bfloat16>(a, G, D, B, s);
  if (q_dtype == 0 && page_dtype == 2) return launch_g<float, int8_t>(a, G, D, B, s);
  if (q_dtype == 1 && page_dtype == 2)
    return launch_g<__nv_bfloat16, int8_t>(a, G, D, B, s);
  return (int)cudaErrorInvalidValue;
}
