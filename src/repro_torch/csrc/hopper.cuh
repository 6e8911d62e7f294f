// Hopper building blocks shared by the flash forward (flash_fwd.cu) and
// backward (flash_bwd.cu): warp-level mma.sync, mbarriers, TMA and bulk
// loads, wgmma descriptors and products, and the host-side tensor maps.
// Every product and tensor map is templated on the 16-bit element type T,
// bf16 or f16 (the paper's f16 training): the two differ only in the type
// suffix of the instruction and the data type of the map.  Included by
// both sources; kernels/build.py hashes it into each library's name and
// passes nvcc the -I of this directory.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  int64_t b, h, s;
};

typedef __nv_bfloat16 bf16;
typedef __half f16;

template <typename T>
__host__ __device__ constexpr bool is_f16() {
  static_assert(std::is_same<T, bf16>::value || std::is_same<T, f16>::value,
                "a 16-bit element type: bf16 or f16");
  return std::is_same<T, f16>::value;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// c += a b on one warp, m16n8k16, T in, fp32 accumulator
#define MMA16(TY)                                                        \
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 " \
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"  \
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])          \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),    \
                 "r"(b1))
template <typename T>
__device__ __forceinline__ void mma16(float* c, const uint32_t* a,
                                      uint32_t b0, uint32_t b1) {
  if constexpr (is_f16<T>())
    MMA16("f16");
  else
    MMA16("bf16");
}
#undef MMA16

// two floats rounded to T (round to nearest: past the f16 range, inf),
// lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (is_f16<T>()) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

template <typename T>
__device__ __forceinline__ float2 unpack(uint32_t v) {
  if constexpr (is_f16<T>())
    return __half22float2(*reinterpret_cast<const __half2*>(&v));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// until the phase of parity `parity` has completed; a wait of ~10 s (a
// lost transfer) traps, so the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) asm volatile("trap;");
  }
}

// a (64 x rows) box at (col, row, h, b) of a (D, S, H, B) tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int row, int h, int b,
                                         uint32_t bar, int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(h),
      "r"(b), "r"(bar)
      : "memory");
}


// a (64 x rows) box of shared memory to (col, row, h, b) of a tensor map
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int col, int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(col), "r"(row), "r"(h), "r"(b), "r"(src)
      : "memory");
}

// until this thread's TMA stores have read their shared memory
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma operand descriptor of a 128-byte-swizzled bf16 tile: K-major (rows
// of the M or N dim, the K dim contiguous: 8-row groups 1024 bytes apart)
// or MN-major (rows of the K dim, M or N contiguous: the same 1024 bytes
// between groups of 8 K rows).  One descriptor spans at most the 64 columns
// of one 128-byte row: a wider tile is stored as 64-column halves, each
// read through its own descriptor.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A B on a warpgroup, m64 nN k16, T (bf16 or f16) in, fp32
// accumulator d (N / 2 registers a thread; `acc` 0 overwrites).  ss: A and
// B from shared memory through descriptors; rs: A from registers (4 a
// thread, the mma.sync A fragment of each warp's 16 rows).  TA / TB: 1 if
// that operand is MN-major (the M or N dim contiguous), 0 if K-major.  The
// accumulator operands of each shape are one macro (D<N>), the instruction
// head another (WG_HEAD), so each statement is written once for both types.
#define WG_HEAD(SHAPE, TY) \
  "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " {"
#define D16 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define D32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
      "+f"(d[31])
#define D64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define WGMMA_SS64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      WG_HEAD("m64n64k16", TY) \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n" \
      : D32 \
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB))
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t da,
                                           uint64_t db, int acc) {
  if constexpr (is_f16<T>())
    WGMMA_SS64("f16");
  else
    WGMMA_SS64("bf16");
}
#undef WGMMA_SS64

#define WGMMA_SS32(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      WG_HEAD("m64n32k16", TY) \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15" \
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n" \
      : D16 \
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB))
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_ss32(float* d, uint64_t da,
                                           uint64_t db, int acc) {
  if constexpr (is_f16<T>())
    WGMMA_SS32("f16");
  else
    WGMMA_SS32("bf16");
}
#undef WGMMA_SS32

#define WGMMA_SS128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      WG_HEAD("m64n128k16", TY) \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n" \
      : D64 \
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB))
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_ss128(float* d, uint64_t da,
                                            uint64_t db, int acc) {
  if constexpr (is_f16<T>())
    WGMMA_SS128("f16");
  else
    WGMMA_SS128("bf16");
}
#undef WGMMA_SS128

#define WGMMA_RS64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      WG_HEAD("m64n64k16", TY) \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
      : D32 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), \
        "n"(TB))
template <typename T, int TB>
__device__ __forceinline__ void wgmma_rs64(float* d, const uint32_t* a,
                                           uint64_t db, int acc) {
  if constexpr (is_f16<T>())
    WGMMA_RS64("f16");
  else
    WGMMA_RS64("bf16");
}
#undef WGMMA_RS64
#undef D16
#undef D32
#undef D64
#undef WG_HEAD

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// the (D = cols, S, H, B) tensor map of a strided T (B, H, S, cols)
// tensor, read in boxes of 64 x `rows` (one 128-byte row of 64 columns: a
// head dim of 128 takes two boxes, at column 0 and 64), 128-byte swizzled,
// rows past S zero-filled
template <typename T>
int tensor_map(CUtensorMap* map, const void* ptr, Strides st, int B, int H,
               int S, int rows, int cols = 64) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                               (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = fn(map,
                        is_f16<T>() ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        4,
                        const_cast<void*>(ptr), dims, bytes, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
