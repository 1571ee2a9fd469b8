// The matmul rate probe P2 (CUDA C++, sm_90a): C = A · B for square-tiled
// N x N operands on the tensor cores, in bf16 and in int8.
//
// Replaces the TPU kernel tools/int8_microbench.py::pallas_mm (the _pk body):
//   bf16  bf16 x bf16 -> f32 sums -> C rounded to bf16 (round to nearest
//         even), as dot(..., preferred_element_type=f32).astype(bf16);
//   int8  s8 x s8 -> s32 sums -> C the low 8 bits of each sum, as XLA's
//         astype(int8) of an int32 wraps.
// A [M, K] and B [K, N] are row-major; M and N are multiples of 128 and K of
// 64 (the wrapper checks), so no tile is ragged.  The wrapper and the plain
// PyTorch version are in ops/mm_probe.py.
//
// Design.  One block of 8 warps computes a 128 x 128 tile of C; warp w owns
// rows 64 (w / 4) .. + 64 and columns 32 (w % 4) .. + 32, as 4 x 4 mma.sync
// tiles of 16 x 8 (bf16 m16n8k16, int8 m16n8k32; tensor_core.cuh).  Each K
// step stages A and B in shared memory with 16-byte loads:
//   bf16  A as [m][k] rows of 40 bf16 (fragment loads conflict-free); B as
//         [k][n] rows of 136 bf16, read with ldmatrix .trans, which hands
//         each lane the (k, k + 1) pairs of one column that mma wants;
//   int8  A as [m][k] rows of 20 words; B transposed to [n][k] while it is
//         staged (each thread turns a 4 x 4 byte block with four byte
//         permutes), the word index XOR-swizzled by n / 4 so that the
//         transposed stores and the fragment loads meet at most 2-way bank
//         conflicts.
// No double buffering, TMA or wgmma: the probe measures what this simple
// mma.sync route gives, beside cuBLAS.
//
// Bound.  2 N^3 operations on N^2 (2 + 2 + 2) bytes (bf16) or N^2 (1 + 1 +
// 1) bytes (int8): at N = 4096, 137 GFLOP against 100 MB, so the tensor
// cores bound it (989 TFLOP/s bf16, 1979 TOPS int8: 0.139 and 0.069 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tensor_core.cuh"

namespace {

using namespace cgr;

constexpr int kThreads = 256;
constexpr int PM = 128, PN = 128;
constexpr int KB16 = 32;  // bf16 K step
constexpr int KB8 = 64;   // int8 K step (bytes)

// d += a · b on one 16 x 8 tile, K = 32, s8 operands, s32 sums.  Fragments
// (PTX ISA, "mma.m16n8k32"), g = lane / 4, t = lane % 4: a[0] = (g,
// 4t..4t+3), a[1] = (g + 8, 4t..), a[2] = (g, 4t + 16..), a[3] = (g + 8,
// 4t + 16..); b[0] = (k 4t..4t+3, n g), b[1] = (k 4t + 16.., n g); the
// lowest k in the low byte; d as for bf16 (tensor_core.cuh).
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const unsigned (&a)[4],
                                             const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The B fragments of two neighbouring 16 x 8 tiles (columns n..n + 15)
// from a k-major shared tile of bf16 (row k holds columns n, n + 1, ...):
// lane l gives the address of row k0 + l % 16, column n + 8 (l / 16);
// ldmatrix .trans hands every lane its (k, k + 1) pairs of column g.
// Returns b0 of the first tile in r[0], r[1], of the second in r[2], r[3].
__device__ __forceinline__ void ldmatrix_b_x4(unsigned (&r)[4],
                                              const void* row_addr) {
  const unsigned a =
      static_cast<unsigned>(__cvta_generic_to_shared(row_addr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__global__ void __launch_bounds__(kThreads)
    mm_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                   const __nv_bfloat16* __restrict__ B,
                   __nv_bfloat16* __restrict__ C, int N, int K) {
  __shared__ __align__(16) unsigned short as[PM][KB16 + 8];
  __shared__ __align__(16) unsigned short bs[KB16][PN + 8];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * PM, n0 = blockIdx.x * PN;
  const int wr = 64 * (warp / 4), wc = 32 * (warp % 4);
  float acc[4][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += KB16) {
    for (int c = tid; c < PM * KB16 / 8; c += kThreads) {
      const int r = c / (KB16 / 8), kc = 8 * (c % (KB16 / 8));
      *reinterpret_cast<uint4*>(&as[r][kc]) = *reinterpret_cast<const uint4*>(
          A + static_cast<size_t>(m0 + r) * K + k0 + kc);
    }
    for (int c = tid; c < KB16 * PN / 8; c += kThreads) {
      const int r = c / (PN / 8), nc = 8 * (c % (PN / 8));
      *reinterpret_cast<uint4*>(&bs[r][nc]) = *reinterpret_cast<const uint4*>(
          B + static_cast<size_t>(k0 + r) * N + n0 + nc);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KB16; ks += 16) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wr + 16 * i + g;
        a[i][0] = ld_b32(&as[r][ks + 2 * t]);
        a[i][1] = ld_b32(&as[r + 8][ks + 2 * t]);
        a[i][2] = ld_b32(&as[r][ks + 8 + 2 * t]);
        a[i][3] = ld_b32(&as[r + 8][ks + 8 + 2 * t]);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        unsigned r[4];
        ldmatrix_b_x4(r, &bs[ks + lane % 16][wc + 16 * jj + 8 * (lane / 16)]);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + wr + 16 * i + g, c = n0 + wc + 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(C + static_cast<size_t>(r) * N + c) =
          __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<__nv_bfloat162*>(C + static_cast<size_t>(r + 8) * N +
                                         c) =
          __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
    }
}

// Word of the transposed int8 B tile holding k = 4 kw .. 4 kw + 3 of
// column n.
__device__ __forceinline__ int bt_index(int n, int kw) {
  return n * (KB8 / 4) + (kw ^ ((n >> 2) & (KB8 / 4 - 1)));
}

// The two low bytes of s0 and s1 (low 8 bits of each sum), as one 16-bit
// pair of int8 outputs.
__device__ __forceinline__ unsigned short pack_s8(int s0, int s1) {
  return static_cast<unsigned short>((s0 & 0xFF) | ((s1 & 0xFF) << 8));
}

__global__ void __launch_bounds__(kThreads)
    mm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                 int8_t* __restrict__ C, int N, int K) {
  __shared__ __align__(16) unsigned as[PM][KB8 / 4 + 4];
  __shared__ __align__(16) unsigned bs[PN * (KB8 / 4)];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * PM, n0 = blockIdx.x * PN;
  const int wr = 64 * (warp / 4), wc = 32 * (warp % 4);
  int acc[4][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += KB8) {
    for (int c = tid; c < PM * KB8 / 16; c += kThreads) {
      const int r = c / (KB8 / 16), kw = 4 * (c % (KB8 / 16));
      *reinterpret_cast<uint4*>(&as[r][kw]) = *reinterpret_cast<const uint4*>(
          A + static_cast<size_t>(m0 + r) * K + k0 + 4 * kw);
    }
    // B: 4 x 4 byte blocks (k 4 kb.., n 4 nb..), a warp on 4 rows of 128
    // consecutive bytes; each becomes four words of 4 k-consecutive bytes
    for (int c = tid; c < (KB8 / 4) * (PN / 4); c += kThreads) {
      const int kb = c / (PN / 4), nb = c % (PN / 4);
      const unsigned* src = reinterpret_cast<const unsigned*>(
          B + static_cast<size_t>(k0 + 4 * kb) * N + n0 + 4 * nb);
      const size_t row = N / 4;
      const unsigned w0 = src[0], w1 = src[row], w2 = src[2 * row],
                     w3 = src[3 * row];
      const unsigned t0 = __byte_perm(w0, w1, 0x5140),
                     t1 = __byte_perm(w0, w1, 0x7362),
                     t2 = __byte_perm(w2, w3, 0x5140),
                     t3 = __byte_perm(w2, w3, 0x7362);
      bs[bt_index(4 * nb + 0, kb)] = __byte_perm(t0, t2, 0x5410);
      bs[bt_index(4 * nb + 1, kb)] = __byte_perm(t0, t2, 0x7632);
      bs[bt_index(4 * nb + 2, kb)] = __byte_perm(t1, t3, 0x5410);
      bs[bt_index(4 * nb + 3, kb)] = __byte_perm(t1, t3, 0x7632);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KB8 / 4; ks += 8) {  // words: 32 k per mma
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wr + 16 * i + g;
        a[i][0] = as[r][ks + t];
        a[i][1] = as[r + 8][ks + t];
        a[i][2] = as[r][ks + 4 + t];
        a[i][3] = as[r + 8][ks + 4 + t];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wc + 8 * j + g;
        b[j][0] = bs[bt_index(n, ks + t)];
        b[j][1] = bs[bt_index(n, ks + 4 + t)];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8_16832(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + wr + 16 * i + g, c = n0 + wc + 8 * j + 2 * t;
      *reinterpret_cast<unsigned short*>(C + static_cast<size_t>(r) * N + c) =
          pack_s8(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<unsigned short*>(C + static_cast<size_t>(r + 8) * N +
                                         c) =
          pack_s8(acc[i][j][2], acc[i][j][3]);
    }
}

}  // namespace

// C [M, N] = A [M, K] · B [K, N] on `stream`, one block per 128 x 128 tile;
// int8 when `int8` is 1, else bf16.  Returns cudaGetLastError().
extern "C" int cgr_mm_probe(const void* A, const void* B, void* C, int M,
                            int N, int K, int int8, void* stream) {
  const dim3 grid(N / PN, M / PM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8)
    mm_s8_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(A), static_cast<const int8_t*>(B),
        static_cast<int8_t*>(C), N, K);
  else
    mm_bf16_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(A),
        static_cast<const __nv_bfloat16*>(B), static_cast<__nv_bfloat16*>(C),
        N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
