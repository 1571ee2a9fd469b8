// Hopper building blocks for sm_90a in inline PTX: mbarriers, the TMA 2-D
// tile load and store (with its bulk groups, the proxy fence and named
// barriers), wgmma shared-memory descriptors of 128-byte swizzled tiles,
// the warpgroup fence / commit / wait, register reallocation between
// warpgroups, and the two wgmma products of the matmul probe P2
// (mm_probe.cu, the first user).
//
// Tiles.  A TMA load through a map encoded with CU_TENSOR_MAP_SWIZZLE_128B
// writes rows of 128 bytes; the 16-byte chunk c of row r lands at chunk
// c ^ (r % 8), so 8 rows make one 1024-byte swizzle atom.  Every tile here
// starts on a 1024-byte boundary.  wgmma reads such a tile through a 64-bit
// descriptor (PTX ISA, "Matrix Descriptor Format": start address >> 4 in
// bits 0-13, LBO >> 4 in 16-29, SBO >> 4 in 32-45, swizzle mode in 62-63):
//   K-major (one row per M or N index, K along the 128-byte row): the
//     8-row groups lie SBO = 1024 bytes apart and LBO is unused (1).  A K
//     step inside the row moves the start address by its bytes: the
//     hardware swizzles the address bits, so the offset composes with it.
//   MN-major (one row per K index, M or N along the row; 64 bf16): SBO is
//     the distance between 8-row groups along K (1024 bytes for
//     consecutive rows), LBO the distance between the 64-wide blocks along
//     M or N.

#pragma once

#include <cuda.h>  // CUtensorMap: types only, nothing of libcuda is linked

#include <cstdint>

namespace cgr {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

// One thread initialises; then fence_barrier_init and a block barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for
// (the TMA loads that complete on this barrier).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so a wait on parity 1 passes at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
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

// -- TMA -----------------------------------------------------------------

// Copy the box at (c0 inner, c1 outer) of the tensor `map` describes into
// shared memory at dst; completes `bar`'s transactions by the box's bytes
// (also where the box reaches past the tensor: those elements are zeros).
// `map` is a __grid_constant__ kernel parameter.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Copy the box at (c0 inner, c1 outer) of the tensor `map` describes from
// shared memory at src to global memory (only the elements inside the
// tensor), in the thread's current bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of the thread's committed bulk groups still read
// their shared memory (`bulk_wait_read`) or are still running at all.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's shared-memory writes visible to TMA (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of `count` threads (a multiple of 32) on named barrier `id`
// (1..15; __syncthreads is 0).
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// -- wgmma descriptors ---------------------------------------------------

__device__ __forceinline__ uint64_t wgmma_desc(const void* tile, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         1ull << 62;  // 128-byte swizzle
}

// A K-major 128-byte swizzled tile (rows along M or N) from `tile`.
__device__ __forceinline__ uint64_t desc_k_major(const void* tile) {
  return wgmma_desc(tile, 16, 1024);
}

// An MN-major 128-byte swizzled tile (rows along K) whose 64-wide MN
// blocks lie `block_bytes` apart.
__device__ __forceinline__ uint64_t desc_mn_major(const void* tile,
                                                  uint32_t block_bytes) {
  return wgmma_desc(tile, block_bytes, 1024);
}

// -- warpgroup order -----------------------------------------------------

// Before the first wgmma, and before a wgmma whose accumulators other
// instructions touched since the last one.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving uses of accumulators across a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Give up or take registers for the whole warpgroup (a multiple of 8 in
// [24, 256]).  The branches of the roles must not join again, or ptxas
// ignores the request.
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -- wgmma products ------------------------------------------------------
//
// Accumulators of a 64 x 256 tile in the warpgroup (PTX ISA, "Register
// Fragments", wgmma .m64nNk*): thread t, warp w = t / 32, lane l holds rows
// r = 16 w + l / 4 and r + 8; d[4 i], d[4 i + 1] are columns 8 i + 2 (l % 4)
// and + 1 of row r, d[4 i + 2], d[4 i + 3] the same columns of row r + 8.

#define CGR_REGS128                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

#define CGR_ACC8(C, d, i)                                                  \
  C(d[(i)]), C(d[(i) + 1]), C(d[(i) + 2]), C(d[(i) + 3]), C(d[(i) + 4]), \
      C(d[(i) + 5]), C(d[(i) + 6]), C(d[(i) + 7])
#define CGR_ACC128(C, d)                                                   \
  CGR_ACC8(C, d, 0), CGR_ACC8(C, d, 8), CGR_ACC8(C, d, 16),               \
      CGR_ACC8(C, d, 24), CGR_ACC8(C, d, 32), CGR_ACC8(C, d, 40),         \
      CGR_ACC8(C, d, 48), CGR_ACC8(C, d, 56), CGR_ACC8(C, d, 64),         \
      CGR_ACC8(C, d, 72), CGR_ACC8(C, d, 80), CGR_ACC8(C, d, 88),         \
      CGR_ACC8(C, d, 96), CGR_ACC8(C, d, 104), CGR_ACC8(C, d, 112),       \
      CGR_ACC8(C, d, 120)

// d (+)= a · b on 64 x 256, K = 16: bf16 A K-major and B MN-major (the
// transpose bit) from shared memory, f32 sums; d is not read when
// `accumulate` is 0.
__device__ __forceinline__ void wgmma_bf16_m64n256k16(float (&d)[128],
                                                      uint64_t a, uint64_t b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" CGR_REGS128
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : CGR_ACC128("+f", d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= a · b on 64 x 256, K = 32: s8 A and B, both K-major (8-bit types
// have no transpose bit), s32 sums; d is not read when `accumulate` is 0.
__device__ __forceinline__ void wgmma_s8_m64n256k32(int (&d)[128], uint64_t a,
                                                    uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" CGR_REGS128
      "}, %128, %129, p;\n}\n"
      : CGR_ACC128("+r", d)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef CGR_ACC128
#undef CGR_ACC8
#undef CGR_REGS128

}  // namespace cgr
