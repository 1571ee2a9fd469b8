// The bf16 tensor-core product for sm_90a (mma.sync, inline PTX), shared
// by the bf16 instantiations of the whole-model and layered kernels
// (fused_model_common.cuh, layered_common.cuh).  The matmul probe
// (mm_probe.cu) runs wgmma from hopper.cuh instead.
//
// Fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A (row-major 16 x 16): a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..),
//     a[2] = (g, 2t + 8..), a[3] = (g + 8, 2t + 8..), two bf16 per 32-bit
//     register, the lower column in the low half;
//   B (16 x 8, k-major per column): b[0] = (k 2t..2t+1, n g),
//     b[1] = (k 2t + 8.., n g);
//   accumulators: d[0], d[1] = (g, 2t), (g, 2t + 1); d[2], d[3] = the same
//     columns of row g + 8.

#pragma once

#include <cuda_bf16.h>

namespace cgr {

// bf16(v), round to nearest even, as f32 and as its 16 bits.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// A stored f32 or bf16 element as f32, and an f32 value stored as T (bf16:
// round to nearest even).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The 32-bit word at p (4-byte aligned shared memory).
__device__ __forceinline__ unsigned ld_b32(const void* p) {
  return *static_cast<const unsigned*>(p);
}

// d += a · b on one 16 x 8 tile, K = 16, bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const unsigned (&a)[4],
                                               const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace cgr
