// Hopper (sm_90a) machinery shared by the warp-specialised kernels
// (flash_attention.cu, flash_attention_bwd.cu, bitplane.cu, planes_mma.cuh):
// mbarriers, TMA tile loads, wgmma fences, the s8 and bf16 products and
// shared-memory matrix descriptors, the bf16 fragment helpers, register
// reallocation, named barriers, and the host-side encoding of TMA tensor
// maps.
//
// The pattern both kernels follow: one producer warp issues TMA loads of
// swizzled tiles into a ring of stages in shared memory, each stage
// guarded by a "full" mbarrier (the producer's arrival plus the bytes the
// TMA unit delivers) and an "empty" one (one arrival per consumer warp once
// its wgmma has read the stage); consumer warpgroups run wgmma on the
// stages in order.  Parities follow the usual convention: round r of a
// stage waits for phase parity r & 1 on "full" and (r & 1) ^ 1 on "empty",
// so the producer's first pass over the ring does not wait.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the TMA unit and other threads.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// The producer's arrival, announcing the bytes its TMA loads will deliver.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// -- TMA ---------------------------------------------------------------------

// One box of a 2-D tensor map (coordinates innermost first) into shared
// memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define ACC_I8(d, i)                                                                     \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

// D (64 x 256, s32) (+)= A (64 x 32) B^T, A and B s8, K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      " %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117,"
      " %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : ACC_I8(d, 0), ACC_I8(d, 8), ACC_I8(d, 16), ACC_I8(d, 24),
        ACC_I8(d, 32), ACC_I8(d, 40), ACC_I8(d, 48), ACC_I8(d, 56),
        ACC_I8(d, 64), ACC_I8(d, 72), ACC_I8(d, 80), ACC_I8(d, 88),
        ACC_I8(d, 96), ACC_I8(d, 104), ACC_I8(d, 112), ACC_I8(d, 120)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}


// D (64 x 128, s32) (+)= A (64 x 32) B^T, A and B s8, K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63}, "
      "%64, %65, p;\n}\n"
      : ACC_I8(d, 0), ACC_I8(d, 8), ACC_I8(d, 16), ACC_I8(d, 24),
        ACC_I8(d, 32), ACC_I8(d, 40), ACC_I8(d, 48), ACC_I8(d, 56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef ACC_I8

// -- bf16 wgmma (the flash-attention kernels) ---------------------------------

#define ACC_F8(d, i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// S (64 x 128, f32) = A (64 x 16) B^T with A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC_F8(d, 0), ACC_F8(d, 8), ACC_F8(d, 16), ACC_F8(d, 24),
        ACC_F8(d, 32), ACC_F8(d, 40), ACC_F8(d, 48), ACC_F8(d, 56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// S (64 x 64, f32) = A (64 x 16) B^T, as above with 64-key tiles.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC_F8(d, 0), ACC_F8(d, 8), ACC_F8(d, 16), ACC_F8(d, 24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// S (64 x 32, f32) = A (64 x 16) B^T, as above with 32-column tiles.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : ACC_F8(d, 0), ACC_F8(d, 8)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// O (64 x 128, f32) += P (64 x 16, bf16 registers) V (16 x 128), V MN-major.
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC_F8(d, 0), ACC_F8(d, 8), ACC_F8(d, 16), ACC_F8(d, 24),
        ACC_F8(d, 32), ACC_F8(d, 40), ACC_F8(d, 48), ACC_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// O (64 x 64, f32) += P V, as above with D = 64.
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC_F8(d, 0), ACC_F8(d, 8), ACC_F8(d, 16), ACC_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// O (64 x 32, f32) += P V, as above with D = 32.
__device__ __forceinline__ void wgmma_m64n32k16_rs_tb(float (&d)[16], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ACC_F8(d, 0), ACC_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// O (64 x 16, f32) += P V, as above with D = 16.
__device__ __forceinline__ void wgmma_m64n16k16_rs_tb(float (&d)[8], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : ACC_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

#undef ACC_F8

// 2^x (MUFU.EX2), flushing denormals; ex2(-inf) = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64 x N accumulator (the m64nN f32 layout) as the bf16 A fragments of
// N / 16 k-steps of 16 columns: the accumulators of 8-column groups 2 kk and
// 2 kk + 1, rounded to bf16 (the accumulator layout is the A fragment
// layout, so P or dS enters the next product from registers as it lies).
template <int N>
__device__ __forceinline__ void pack_p(const float (&sacc)[N / 2], uint32_t (&pa)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
  }
}

// Byte offset of 16-byte chunk `ch` of row r in a tile of kSwizzle-byte rows,
// in TMA's swizzle: the chunk index XOR the row's bits above the 128-byte line.
template <int kSwizzle>
__device__ __forceinline__ int swizzled_chunk(int r, int ch) {
  return r * kSwizzle + ((ch ^ ((r * kSwizzle >> 7) & (kSwizzle / 16 - 1))) * 16);
}

// Keeps the compiler from moving accesses of an accumulator register across
// the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(int& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(r[i]);
}

// The shared-memory matrix descriptor of a tile written by TMA with a
// swizzle span of kSwizzle = 128, 64 or 32 bytes: rows of kSwizzle bytes in
// atoms of 8 rows, the tile aligned to 1,024 bytes.  K-major operands (the
// K extent inside a row) use only the 8-row-group stride (SBO = 8 kSwizzle
// bytes; LBO is ignored); an MN-major operand also gives the stride between
// its column blocks of kSwizzle bytes as LBO.  A k-step inside a row
// advances `addr` by its bytes.  Layout types: 1 = 128-byte swizzle, 2 = 64,
// 3 = 32.
template <int kSwizzle>
__device__ __forceinline__ uint64_t swizzled_desc(uint32_t addr, uint32_t lbo_bytes = 16) {
  static_assert(kSwizzle == 128 || kSwizzle == 64 || kSwizzle == 32, "swizzle span");
  constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : kSwizzle == 64 ? 2 : 3;
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>(((8 * kSwizzle) >> 4) & 0x3FFF) << 32;
  d |= kLayout << 62;
  return d;
}

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes = 16) {
  return swizzled_desc<128>(addr, lbo_bytes);
}

// Orders this thread's generic-proxy writes to shared memory (st.shared)
// before later async-proxy reads of them (wgmma operands): a producer that
// writes a tile with ordinary stores fences, then arrives on the barrier
// its consumers wait on.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- warp specialisation -----------------------------------------------------

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// A barrier among `count` threads (a multiple of 32); id 0 is __syncthreads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Counts this warp's threads at barrier `id` (of `count` threads) without
// waiting for the others: a signal to the threads that bar.sync on it.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// -- host: tensor maps -------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda; null if the driver does not offer it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A tiled tensor map of `rank` dimensions (innermost first; strides in
// bytes of dimensions 1.. as cuTensorMapEncodeTiled takes them), swizzled
// over 128, 64 or 32 bytes (the box's inner extent must fit in that span).
// Elements outside the tensor read as zero.  Returns 0 on success, or
// cudaErrorInvalidValue.
inline int encode_swizzled(CUtensorMap* map, CUtensorMapDataType type, int rank,
                           const void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                           const cuuint32_t* box, int swizzle_bytes) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || (swizzle_bytes != 128 && swizzle_bytes != 64 && swizzle_bytes != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapSwizzle swizzle = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

inline int encode_sw128(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                        const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  return encode_swizzled(map, type, rank, base, dims, strides, box, 128);
}

}  // namespace hopper
