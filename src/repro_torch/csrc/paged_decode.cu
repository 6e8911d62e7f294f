// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:160
// `paged_decode_attention` / `_paged_kernel` (:56): one new query token per
// slot attends over that slot's kv_len cached tokens, which live in a global
// page pool (P, page_size, KV, Dh) addressed through block_table[b, p].
// Same semantics: page ids are clamped to [0, P-1], the walk stops at
// ceil(kv_len / page_size) pages and the tail page is masked per token,
// kv_len is clamped to the table's capacity, int8 entries are
// int * scale[page, kv_head], the tanh softcap is applied to the scaled
// logits, and a slot with kv_len == 0 writes zeros.  The pool is read in its
// (P, page_size, KV, Dh) layout through strides: the Pallas wrapper's
// moveaxis copy of the whole pool is not carried over.
//
// Bound.  Decode attention reads every live K and V byte once and does ~4
// operations per element, so bytes bound it: at the serve geometry (4 slots
// of 600-1040 tokens, 32 KV heads x 128) ~53 MB of bf16 pages, 16 us at
// 3.35 TB/s, half that for int8 pages.  Reaching it takes tens of KB in
// flight on every SM for the whole launch.  chip_smoke.py times the bf16
// route beside one torch.sum over as many contiguous bytes.  On the TPU the
// page walk is a sequential grid axis with the table in scalar prefetch;
// here that walk is what has to be cut up.
//
// Design (16-bit and int8 pages of 8, 16 or 32 tokens,
// `paged_decode_split_kernel`, templated on the page size):
// * The split.  The grid is (KV, B, n_split): each block takes a contiguous
//   run of `pps` pages of one slot's table for one KV head.  The wrapper's
//   `split_plan` picks pps from the table width, the batch and the SM
//   count: it splits where the (slot, KV head) pairs would leave SMs idle
//   and where a table holds more than 128 pages, not further -- once every
//   SM streams pages the card's memory is the limit, and more splits only
//   add their combine (on an H100 at 4 slots x 32 heads: 0.0386 ms in 5
//   splits of 13 pages, 0.0345 unsplit).  Live lengths are only on the
//   device, so a block whose run starts past its slot's last page exits at
//   once.  Inside a block each of its 4 warps takes pages w, w + 4, ...
// * The ring.  Lane i of a warp reads the block-table entry (and the int8
//   scales) of the warp's i-th page once, up front.  Each warp then streams
//   its K and V pages through its own 3-stage ring in shared memory with
//   16-byte cp.async copies (two pages in flight while it scores a third),
//   so the only synchronisation in the walk is __syncwarp.  Rows past
//   kv_len on the tail page are zero-filled instead of read.  TMA (a 4-D
//   tensor map of the pool) would save the copy instructions but needs a
//   descriptor encoded on the host for every call, and the decode step is
//   host-bound already: not taken.
// * Scoring a page at once.  A lane holds 8 head-dim elements of a token row
//   (16 bytes of bf16, 8 of int8 in shared memory), the Dh / 8 lanes of one
//   row read it together and a lane scores page_size / (32 / (Dh / 8))
//   tokens of the page.  One reduce-scatter across the row's lanes (at
//   Dh = 128 and pages of 16, 8 shuffles for a lane's 8 tokens, where a
//   shuffle tree a token would take 32)
//   leaves every token's score in its own lanes; the page then takes one
//   max, one rescale of the accumulator and exp2f with log2(e) folded in,
//   never one per token.  int8 is dequantised per score and per
//   probability: k_scale multiplies the page's scores once and v_scale its
//   probabilities once, never an element.
// * The combine.  The warps' (m, l, acc) merge in shared memory in warp
//   order.  A slot whose live pages fit one split writes its output there;
//   otherwise each split writes its fp32 partial to a workspace and takes an
//   integer ticket, and the last of the slot's live splits to arrive adds
//   the partials in split order and sets the ticket back to 0, so the
//   wrapper keeps one zeroed ticket buffer and launches no memset.  A split
//   with no live token does not contribute, kv_len 0 still gives exact
//   zeros, and the output is the same bits every launch.
//
// The first port's kernel, `paged_decode_walk_kernel`, takes every other
// page: f32 pages (tests and small cases), and 16-bit and int8 pages of any
// other size or with rows that 16-byte copies cannot read.  One block of 16
// warps per (KV head, slot), warps taking pages w, w + 16, ..., an online
// softmax a token.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

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

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ks;  // null unless int8 pages
  const float* vs;
  const int* bt;
  const int* kv_len;
  void* out;
  float* part;        // split partials (B, KV, n_split, G, Dh + 2) fp32
  unsigned* tickets;  // (B * KV) zeros
  int64_t q_sb, q_sh;        // q (B, H, Dh)
  int64_t k_sp, k_st, k_sh;  // k pages (P, ps, KV, Dh)
  int64_t v_sp, v_st, v_sh;
  int64_t s_sp, s_sh;        // scales (P, KV)
  int64_t bt_sb;             // block table (B, mp)
  int64_t o_sb, o_sh;        // out (B, H, Dh)
  int KV, P, ps, mp, pps, n_split;
  float softcap, scale;
};

// ---------------------------------------------------------------------------
// 16-bit and int8 pages: the split kernel
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;   // warps a block
constexpr int kStages = 3;  // pages in a warp's ring
constexpr int kW = 8;       // head-dim elements a lane holds of a token row

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four int8 in one word -> fp32: each byte, its sign bit flipped, becomes the
// low mantissa byte of 2^23 + 128 + x, so one permute and one add a value
__device__ __forceinline__ void i8x4_to_f(unsigned w, float* o) {
  w ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + i)) -
           8388736.f;
}

// kW elements of a row in shared memory -> fp32
template <typename PT>
struct Slice;
template <>
struct Slice<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Slice<int8_t> {
  static __device__ __forceinline__ void load(const int8_t* p, float* o) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    i8x4_to_f(r.x, o);
    i8x4_to_f(r.y, o + 4);
  }
};

// Reduce-scatter of the N partial sums each lane holds, one a token: each
// step halves the values a lane keeps (the upper half where its lane bit OFF
// is set) and adds its partner's copy of that half.  After log2(N) steps
// v[0] is the sum over the N lanes OFF, OFF / 2, ... apart of the partial of
// token (lane bits OFF, OFF / 2, ...) -- N tokens for N - 1 shuffles.
template <int N, int OFF>
__device__ __forceinline__ void scatter(float* v, int lane) {
  if constexpr (N > 1) {
    const bool up = lane & OFF;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = up ? v[i] : v[i + N / 2];
      const float keep = up ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
    }
    scatter<N / 2, OFF / 2>(v, lane);
  }
}

template <typename QT, typename PT, int G, int D, int PS>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_split_kernel(Args a) {
  constexpr bool kQuant = sizeof(PT) == 1;
  constexpr int SL = D / kW;   // lanes that read one token row
  constexpr int TG = 32 / SL;  // rows a warp reads at once
  constexpr int TPL = PS / TG; // tokens a lane scores on a page
  constexpr int DUP = SL / TPL;  // lanes left holding one token's score
  constexpr int ROW = D * (int)sizeof(PT);  // bytes of a token's head row
  constexpr int PAGE = PS * D;              // elements of a K (or V) page
  constexpr int CHUNKS = PS * ROW / 16;     // 16-byte copies of a page
  constexpr int RING = kStages * 2 * PAGE * (int)sizeof(PT);  // bytes a warp
  static_assert(TPL >= 1 && TPL <= SL && CHUNKS % 32 == 0, "page geometry");
  static_assert(G * (D + 2) * 4 <= RING, "warp partial must fit its ring");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tg = lane / SL, sl = lane % SL;
  const int p_first = split * a.pps + warp;  // this warp's first page
  // lane i: the page id of the warp's i-th page of the run
  int my_pid = 0;
  if (lane * kWarps + warp < a.pps && p_first + kWarps * lane < a.mp)
    my_pid = min(max(a.bt[b * a.bt_sb + p_first + kWarps * lane], 0),
                 a.P - 1);
  const int len = min(max(a.kv_len[b], 0), a.mp * PS);
  const int n_pages = (len + PS - 1) / PS;
  const int n_live = (n_pages + a.pps - 1) / a.pps;  // splits with a page
  QT* out = static_cast<QT*>(a.out) + b * a.o_sb + (int64_t)kvh * G * a.o_sh;
  if (split >= n_live) {
    if (split == 0)  // kv_len == 0
      for (int i = threadIdx.x; i < G * D; i += kWarps * 32)
        out[(i / D) * a.o_sh + i % D] = from_f<QT>(0.f);
    return;
  }
  const int p_hi = min(split * a.pps + a.pps, n_pages);
  const int cnt = p_first < p_hi ? (p_hi - p_first + kWarps - 1) / kWarps : 0;
  float my_ks = 1.f, my_vs = 1.f;
  if (kQuant && lane < cnt) {
    my_ks = a.ks[my_pid * a.s_sp + kvh * a.s_sh];
    my_vs = a.vs[my_pid * a.s_sp + kvh * a.s_sh];
  }

  PT* ring = reinterpret_cast<PT*>(smem + warp * RING);
  const char* kbase = static_cast<const char*>(a.kp) +
                      kvh * a.k_sh * (int64_t)sizeof(PT);
  const char* vbase = static_cast<const char*>(a.vp) +
                      kvh * a.v_sh * (int64_t)sizeof(PT);
  const int64_t k_row = a.k_st * sizeof(PT), v_row = a.v_st * sizeof(PT);
  // page i of the warp into stage i % kStages; rows past kv_len zero-filled
  auto load_page = [&](int i) {
    const int pid = __shfl_sync(kFull, my_pid, i);
    const int rows = min(PS, len - (p_first + kWarps * i) * PS);
    char* kd = reinterpret_cast<char*>(ring + (i % kStages) * 2 * PAGE);
    char* vd = kd + PAGE * sizeof(PT);
    const char* ksrc = kbase + pid * a.k_sp * (int64_t)sizeof(PT);
    const char* vsrc = vbase + pid * a.v_sp * (int64_t)sizeof(PT);
#pragma unroll
    for (int c = lane; c < CHUNKS; c += 32) {
      const int r = c / (ROW / 16), col = c % (ROW / 16) * 16;
      const int n = r < rows ? 16 : 0;
      cp_async16(kd + r * ROW + col, ksrc + r * k_row + col, n);
      cp_async16(vd + r * ROW + col, vsrc + r * v_row + col, n);
    }
  };

  float qr[G][kW];
  const QT* qb = static_cast<const QT*>(a.q) + b * a.q_sb +
                 (int64_t)kvh * G * a.q_sh + sl * kW;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kW; ++e) qr[g][e] = to_f(qb[g * a.q_sh + e]) * a.scale;
  float m[G], l[G], acc[G][kW];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kW; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < cnt) load_page(i);
    cp_async_commit();
  }
  // after the reduce-scatter this lane holds the score of token `tok`
  const int tok = tg + TG * (sl / DUP);
  const bool owner = sl % DUP == 0;
  for (int i = 0; i < cnt; ++i) {
    if (i + kStages - 1 < cnt) load_page(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const PT* kt = ring + (i % kStages) * 2 * PAGE;
    const PT* vt = kt + PAGE;
    const int live = len - (p_first + kWarps * i) * PS;  // tokens from here on
    const float ksc = kQuant ? __shfl_sync(kFull, my_ks, i) : 1.f;
    const float vsc = kQuant ? __shfl_sync(kFull, my_vs, i) : 1.f;
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sp[TPL];
#pragma unroll
      for (int j = 0; j < TPL; ++j) {
        float kf[kW];
        Slice<PT>::load(kt + (tg + TG * j) * D + sl * kW, kf);
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kW; ++e) s = fmaf(qr[g][e], kf[e], s);
        sp[j] = s;
      }
      scatter<TPL, SL / 2>(sp, lane);
      float s = sp[0];
#pragma unroll
      for (int off = DUP / 2; off > 0; off /= 2)
        s += __shfl_xor_sync(kFull, s, off);
      s *= ksc;
      if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
      s = tok < live ? s * kLog2e : -INFINITY;  // the tail page's mask
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float corr = exp2f(m[g] - m_new);
      p[g] = exp2f(s - m_new);
      l[g] = l[g] * corr + (owner ? p[g] : 0.f);
#pragma unroll
      for (int e = 0; e < kW; ++e) acc[g][e] *= corr;
      m[g] = m_new;
      p[g] *= vsc;
    }
#pragma unroll
    for (int j = 0; j < TPL; ++j) {
      float vf[kW];
      Slice<PT>::load(vt + (tg + TG * j) * D + sl * kW, vf);
      const int src = tg * SL + j * DUP;  // a lane holding token tg + TG j
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = __shfl_sync(kFull, p[g], src);
#pragma unroll
        for (int e = 0; e < kW; ++e) acc[g][e] = fmaf(pj, vf[e], acc[g][e]);
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();

  // the warp's (acc[G][D], m[G], l[G]) into its own ring
  float* wp = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float lt = l[g];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) lt += __shfl_xor_sync(kFull, lt, off);
#pragma unroll
    for (int e = 0; e < kW; ++e)
#pragma unroll
      for (int off = SL; off < 32; off *= 2)
        acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], off);
    if (tg == 0)
#pragma unroll
      for (int e = 0; e < kW; ++e) wp[g * D + sl * kW + e] = acc[g][e];
    if (lane == 0) {
      wp[G * D + g] = m[g];
      wp[G * D + G + g] = lt;
    }
  }
  __syncthreads();

  // the block's warps merged in warp order: the output, or the split's
  // partial (acc, m, l) in the workspace
  const int64_t slot = ((int64_t)b * a.KV + kvh) * a.n_split;
  float* part = a.part + (slot + split) * G * (D + 2);
  for (int i = threadIdx.x; i < G * D; i += kWarps * 32) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = reinterpret_cast<const float*>(smem + w * RING);
      if (pw[G * D + G + g] > 0.f) mx = fmaxf(mx, pw[G * D + g]);
    }
    float lsum = 0.f, osum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = reinterpret_cast<const float*>(smem + w * RING);
      const float lw = pw[G * D + G + g];
      if (lw > 0.f) {
        const float f = exp2f(pw[G * D + g] - mx);
        lsum += lw * f;
        osum += pw[i] * f;
      }
    }
    if (n_live == 1) {
      out[g * a.o_sh + d] = from_f<QT>(osum / lsum);
    } else {
      part[i] = osum;
      if (d == 0) {
        part[G * D + g] = mx;
        part[G * D + G + g] = lsum;
      }
    }
  }
  if (n_live == 1) return;

  // ticket: the last of the slot's live splits adds the partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* ticket = a.tickets + b * a.KV + kvh;
    s_last = atomicAdd(ticket, 1u) == (unsigned)(n_live - 1);
    if (s_last) *ticket = 0u;  // zero again for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* base = a.part + slot * G * (D + 2);
  for (int i = threadIdx.x; i < G * D; i += kWarps * 32) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
    for (int s = 0; s < n_live; ++s)
      mx = fmaxf(mx, __ldcg(base + s * G * (D + 2) + G * D + g));
    float lsum = 0.f, osum = 0.f;
    for (int s = 0; s < n_live; ++s) {  // in split order
      const float* ps = base + s * G * (D + 2);
      const float f = exp2f(__ldcg(ps + G * D + g) - mx);
      lsum += __ldcg(ps + G * D + G + g) * f;
      osum += __ldcg(ps + i) * f;
    }
    out[g * a.o_sh + d] = from_f<QT>(osum / lsum);
  }
}

template <typename QT, typename PT, int G, int D, int PS>
int launch_split(const Args& a, int B, cudaStream_t stream) {
  auto kern = paged_decode_split_kernel<QT, PT, G, D, PS>;
  const int smem = kWarps * kStages * 2 * PS * D * (int)sizeof(PT);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.KV, B, a.n_split), kWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the page sizes the split kernel is built for (the wrapper's SPLIT_PAGES)
template <typename QT, typename PT, int G, int D>
int split_ps(const Args& a, int B, cudaStream_t s) {
  switch (a.ps) {
    case 8: return launch_split<QT, PT, G, D, 8>(a, B, s);
    case 16: return launch_split<QT, PT, G, D, 16>(a, B, s);
    case 32: return launch_split<QT, PT, G, D, 32>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename QT, typename PT, int G>
int split_d(const Args& a, int D, int B, cudaStream_t s) {
  switch (D) {
    case 64: return split_ps<QT, PT, G, 64>(a, B, s);
    case 128: return split_ps<QT, PT, G, 128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename QT, typename PT>
int split_g(const Args& a, int G, int D, int B, cudaStream_t s) {
  switch (G) {
    case 1: return split_d<QT, PT, 1>(a, D, B, s);
    case 2: return split_d<QT, PT, 2>(a, D, B, s);
    case 4: return split_d<QT, PT, 4>(a, D, B, s);
    case 8: return split_d<QT, PT, 8>(a, D, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Every other page: the first port's kernel
// ---------------------------------------------------------------------------

constexpr int NW = 16;  // warps per block
constexpr int TPC = 4;  // tokens loaded per chunk

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

template <typename QT, typename PT, int G, int D>
__global__ void __launch_bounds__(NW * 32) paged_decode_walk_kernel(Args a) {
  constexpr int VEC = D / 32;
  constexpr bool kQuant = sizeof(PT) == 1;
  extern __shared__ float fsmem[];
  float* sm_m = fsmem;             // NW x G
  float* sm_l = sm_m + NW * G;     // NW x G
  float* sm_acc = sm_l + NW * G;   // NW x G x D

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
            s += __shfl_xor_sync(kFull, s, off);
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
int launch_walk(const Args& a, int B, cudaStream_t stream) {
  auto kern = paged_decode_walk_kernel<QT, PT, G, D>;
  const size_t smem = sizeof(float) * NW * G * (2 + D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.KV, B), NW * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename QT, typename PT, int G>
int walk_d(const Args& a, int D, int B, cudaStream_t s) {
  switch (D) {
    case 64: return launch_walk<QT, PT, G, 64>(a, B, s);
    case 128: return launch_walk<QT, PT, G, 128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename QT, typename PT>
int walk_g(const Args& a, int G, int D, int B, cudaStream_t s) {
  switch (G) {
    case 1: return walk_d<QT, PT, 1>(a, D, B, s);
    case 2: return walk_d<QT, PT, 2>(a, D, B, s);
    case 4: return walk_d<QT, PT, 4>(a, D, B, s);
    case 8: return walk_d<QT, PT, 8>(a, D, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16.  page_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (then k_scale / v_scale are (P, KV) float32).
// strides (13 int64 values, in elements):
//   q (b, h); k pages (page, token, head); v pages (page, token, head);
//   scales (page, head); block table (b); out (b, h).
// The head dim of q, pages and out is contiguous.  block_table (B, mp) and
// kv_len (B,) are int32.  n_split 0 takes the walk kernel, which ignores
// `part`, `tickets` and `pps`.  Otherwise 16-bit and int8 pages of 8, 16 or
// 32 tokens take the split kernel over runs of `pps` pages, `n_split` runs a
// slot (n_split * pps >= mp), with `part` a (B, KV, n_split, G, D + 2) fp32
// workspace and `tickets` B * KV int32 that are zero before the launch and
// after it (both unread, and may be null, when n_split is 1).
// Returns cudaGetLastError() after the launch.
extern "C" int paged_decode(int q_dtype, int page_dtype, int G, int D,
                            const void* q, const void* kp, const void* vp,
                            const float* ks, const float* vs, const int* bt,
                            const int* kv_len, void* out, float* part,
                            unsigned* tickets, const int64_t* st, int B,
                            int KV, int P, int ps, int mp, int pps,
                            int n_split, float softcap, float scale,
                            void* stream) {
  Args a;
  a.q = q; a.kp = kp; a.vp = vp; a.ks = ks; a.vs = vs; a.bt = bt;
  a.kv_len = kv_len; a.out = out; a.part = part; a.tickets = tickets;
  a.q_sb = st[0]; a.q_sh = st[1];
  a.k_sp = st[2]; a.k_st = st[3]; a.k_sh = st[4];
  a.v_sp = st[5]; a.v_st = st[6]; a.v_sh = st[7];
  a.s_sp = st[8]; a.s_sh = st[9];
  a.bt_sb = st[10];
  a.o_sb = st[11]; a.o_sh = st[12];
  a.KV = KV; a.P = P; a.ps = ps; a.mp = mp; a.pps = pps; a.n_split = n_split;
  a.softcap = softcap; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split == 0) {
    if (q_dtype == 0 && page_dtype == 0)
      return walk_g<float, float>(a, G, D, B, s);
    if (q_dtype == 1 && page_dtype == 1)
      return walk_g<__nv_bfloat16, __nv_bfloat16>(a, G, D, B, s);
    if (q_dtype == 0 && page_dtype == 2)
      return walk_g<float, int8_t>(a, G, D, B, s);
    if (q_dtype == 1 && page_dtype == 2)
      return walk_g<__nv_bfloat16, int8_t>(a, G, D, B, s);
    return (int)cudaErrorInvalidValue;
  }
  if (pps < 1 || n_split < 1 || pps > 32 * kWarps ||
      (int64_t)pps * n_split < mp)
    return (int)cudaErrorInvalidValue;
  if (q_dtype == 1 && page_dtype == 1)
    return split_g<__nv_bfloat16, __nv_bfloat16>(a, G, D, B, s);
  if (q_dtype == 0 && page_dtype == 2)
    return split_g<float, int8_t>(a, G, D, B, s);
  if (q_dtype == 1 && page_dtype == 2)
    return split_g<__nv_bfloat16, int8_t>(a, G, D, B, s);
  return (int)cudaErrorInvalidValue;
}
