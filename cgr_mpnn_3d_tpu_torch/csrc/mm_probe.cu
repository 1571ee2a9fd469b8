// The matmul rate probe P2 (CUDA C++, sm_90a): C = A · B on the tensor
// cores, in bf16 and in int8.
//
// Replaces the TPU kernel tools/int8_microbench.py::pallas_mm (the _pk body):
//   bf16  bf16 x bf16 -> f32 sums -> C rounded to bf16 (round to nearest
//         even), as dot(..., preferred_element_type=f32).astype(bf16);
//   int8  s8 x s8 -> s32 sums -> C the low 8 bits of each sum, as XLA's
//         astype(int8) of an int32 wraps.
// A [M, K] and B [K, N] are row-major; M and N are multiples of 128 and K of
// 64 (the wrapper checks).  The wrapper and the plain PyTorch version are in
// ops/mm_probe.py.
//
// Design.  A persistent grid, one block per SM, walks the 128 x 256 tiles of
// C (M fastest).  A block is three warpgroups (hopper.cuh):
//   producer   gives up registers (setmaxnreg 40); one thread issues the
//              TMA loads of each K block -- 128 bytes of K: 64 bf16 or 128
//              int8 values -- into a ring of shared-memory stages of 48 KB
//              (A 128 x 128 B, B 256 x 128 B, 128-byte swizzled), after the
//              stage's "empty" mbarrier, completing its "full" one by the
//              stage's bytes;
//   consumers  two warpgroups (setmaxnreg 232), each the 64 rows 64 c ..
//              of the tile, 128 f32 or s32 accumulators a thread: after a
//              stage's "full" barrier, four wgmma m64n256 (k16 bf16, k32
//              s8) from shared memory, one committed group in flight; when
//              the group before has retired, its stage goes back to the
//              producer.
// Epilogue: each consumer writes its 64 x 256 half of C (bf16 rounded to
// nearest even; int8 the low bytes) into shared memory in the TMA store's
// swizzled layout, and one thread stores it with TMA while the warpgroup
// starts the next tile and the producer already fills its stages.  The
// staged C tile (64 KB bf16, 32 KB int8) leaves room for 3 stages in bf16
// and 4 in int8 under 227 KB (tools/mm_probe_parts.py times the epilogue,
// the store and one stage fewer against this build).
// bf16 B is read as it lies, MN-major: four TMA boxes of 64 n x 64 k, 8 KB
// apart (the descriptor's LBO), and the instruction's transpose bit.  wgmma
// takes 8-bit operands K-major only, so for int8 a transpose kernel writes
// Bt [N, K] first (its own entry point; mm_probe runs it in the same call,
// in the scratch the wrapper allocates) and the GEMM reads Bt as one
// 256 x 128 B box.  N not a multiple of 256 leaves the last tile column
// half past the matrix: TMA loads zeros there and stores no column >= N;
// K not a multiple of 128 (int8) likewise.  The tensor maps are encoded on
// the host at every call (the pointers change), through libcuda's
// cuTensorMapEncodeTiled found with cudaGetDriverEntryPoint: the library
// does not link libcuda.
//
// Bound.  2 N^3 operations on N^2 (2 + 2 + 2) bytes (bf16) or N^2 (1 + 1 +
// 1) bytes (int8): at N = 4096, 137 GFLOP against 100 MB, so the tensor
// cores bound it (989 TFLOP/s bf16, 1979 TOPS int8: 0.139 and 0.069 ms).
// The int8 transpose moves 2 N^2 bytes more (0.010 ms at 3.35 TB/s).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace cgr;

constexpr int kBM = 128, kBN = 256;  // C tile
constexpr int kRow = 128;            // bytes of K per stage (one swizzled row)
constexpr int kABytes = kBM * kRow;  // 16 KB
constexpr int kBBytes = kBN * kRow;  // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kBox16 = 64;  // bf16 B box: 64 n (128 bytes) x 64 k rows
constexpr int kHalf = kBM / 2;  // rows of C a consumer owns
constexpr int kCBox = kHalf * 128;  // C box: 64 rows x 128 bytes, swizzled
constexpr int kThreads = 384;  // producer warpgroup + two consumers

// The staged C tile (bf16 64 KB, int8 32 KB) and as many stages of the
// ring as fit beside it in 227 KB.
template <bool kInt8>
constexpr int kCBytes = kBM * kBN * (kInt8 ? 1 : 2);
template <bool kInt8>
constexpr int kStages = kInt8 ? 4 : 3;
template <bool kInt8>
constexpr int kSmemBytes = kStages<kInt8> * kStageBytes + kCBytes<kInt8> +
                           1024 + 2 * kStages<kInt8> * 8;

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
    mm_kernel(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb,
              const __grid_constant__ CUtensorMap tc, int M, int N, int K) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int kBK = kInt8 ? kRow : kRow / 2;  // K values per stage
  constexpr int S = kStages<kInt8>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned stages (the swizzle atom), the C tile, the barriers
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* smem_c = smem + S * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_c + kCBytes<kInt8>);
  uint64_t* empty = full + S;
  const int tiles_m = M / kBM, tiles = tiles_m * ((N + kBN - 1) / kBN);
  const int kblocks = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive_expect_tx
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    regs_dec<40>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * kBM, n0 = (tile / tiles_m) * kBN;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_arrive_expect_tx(&full[s], kStageBytes);
          uint8_t* a = smem + s * kStageBytes;
          uint8_t* b = a + kABytes;
          tma_load_2d(a, &ta, &full[s], kb * kBK, m0);
          if constexpr (kInt8) {
            tma_load_2d(b, &tb, &full[s], kb * kBK, n0);
          } else {
#pragma unroll
            for (int j = 0; j < kBN / kBox16; ++j)
              tma_load_2d(b + j * kBox16 * kRow, &tb, &full[s],
                          n0 + j * kBox16, kb * kBK);
          }
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumers
    regs_inc<232>();
    const int c = threadIdx.x / 128 - 1;  // rows 64 c .. 64 c + 63 of a tile
    const int t = threadIdx.x % 128, w = t / 32, l = t % 32, q = l % 4;
    // this consumer's half of the staged C tile: boxes of 64 rows x 128 B
    uint8_t* cs = smem_c + c * (kCBytes<kInt8> / 2);
    const int r = 16 * w + l / 4;  // its rows r and r + 8 of the half
    Acc acc[128] = {};
    int s = 0, last = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % tiles_m) * kBM, n0 = (tile / tiles_m) * kBN;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&full[s], phase);
        const uint8_t* a = smem + s * kStageBytes + c * kHalf * kRow;
        const uint8_t* b = smem + s * kStageBytes + kABytes;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // 32 bytes of K each
          if constexpr (kInt8)
            wgmma_s8_m64n256k32(acc, desc_k_major(a + 32 * k),
                                desc_k_major(b + 32 * k), kb | k);
          else  // 16 k rows of B = two 1024-byte groups
            wgmma_bf16_m64n256k16(acc, desc_k_major(a + 32 * k),
                                  desc_mn_major(b + 16 * kRow * k,
                                                kBox16 * kRow),
                                  kb | k);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the group of the stage before has retired
        if (kb > 0 && t == 0) mbar_arrive(&empty[last]);
        last = s;
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(&empty[last]);
      // Epilogue: the half tile into shared memory in the TMA store's
      // swizzled layout (16-byte chunk x of row r at x ^ (r % 8): a warp's
      // 8 rows fall on 8 chunks, no bank conflicts), then one thread
      // stores it while the warpgroup goes on to the next tile.
      if (t == 0) bulk_wait_read<0>();  // the last tile's store has read cs
      named_barrier(1 + c, 128);
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {  // acc[4 i ..]: columns 8 i ..
        if constexpr (kInt8) {
          // 8 i + 2 q is byte (i % 16) * 8 + 2 q of box i / 16
          uint8_t* box = cs + (i / 16) * kCBox;
          const int x = (i % 16) / 2, o = 8 * (i % 2) + 2 * q;
          // the two low bytes of the sums, the lower column first
          *reinterpret_cast<unsigned short*>(
              box + r * 128 + 16 * (x ^ (r % 8)) + o) =
              static_cast<unsigned short>((acc[4 * i] & 0xFF) |
                                          ((acc[4 * i + 1] & 0xFF) << 8));
          *reinterpret_cast<unsigned short*>(
              box + (r + 8) * 128 + 16 * (x ^ (r % 8)) + o) =
              static_cast<unsigned short>((acc[4 * i + 2] & 0xFF) |
                                          ((acc[4 * i + 3] & 0xFF) << 8));
        } else {
          // 8 i + 2 q is chunk i % 8, bytes 4 q .. of box i / 8
          uint8_t* box = cs + (i / 8) * kCBox;
          const int x = i % 8;
          *reinterpret_cast<__nv_bfloat162*>(
              box + r * 128 + 16 * (x ^ (r % 8)) + 4 * q) =
              __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              box + (r + 8) * 128 + 16 * (x ^ (r % 8)) + 4 * q) =
              __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
        }
      }
      fence_proxy_async();
      named_barrier(1 + c, 128);
      if (t == 0) {  // columns past N are not stored
        constexpr int kBoxCols = kInt8 ? 128 : 64;
#pragma unroll
        for (int j = 0; j < kBN / kBoxCols; ++j)
          tma_store_2d(&tc, cs + j * kCBox, n0 + j * kBoxCols,
                       m0 + c * kHalf);
        bulk_commit();
      }
    }
    if (t == 0) bulk_wait<0>();  // the last store is done before exit
  }
}

// Bt [N, K] = B [K, N]ᵀ for int8: a block turns a 64 x 64 byte tile through
// shared memory, 16-byte loads and stores (K and N multiples of 64).
constexpr int kT = 64, kTPad = 68;  // rows 68 bytes apart: 2-way conflicts

__global__ void __launch_bounds__(256)
    transpose_s8_kernel(const uint8_t* __restrict__ B,
                        uint8_t* __restrict__ Bt, int K, int N) {
  __shared__ __align__(16) uint8_t tile[kT][kTPad];
  const int k0 = blockIdx.y * kT, n0 = blockIdx.x * kT;
  const int r = threadIdx.x / 4, q = 16 * (threadIdx.x % 4);
  const uint4 v = *reinterpret_cast<const uint4*>(
      B + static_cast<size_t>(k0 + r) * N + n0 + q);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<unsigned*>(&tile[r][q + 4 * j]) = w[j];
  __syncthreads();
  // thread: output row n = r, its k q .. q + 15
  unsigned o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = tile[q + 4 * j][r] | tile[q + 4 * j + 1][r] << 8 |
           tile[q + 4 * j + 2][r] << 16 |
           static_cast<unsigned>(tile[q + 4 * j + 3][r]) << 24;
  *reinterpret_cast<uint4*>(Bt + static_cast<size_t>(n0 + r) * K + k0 + q) =
      make_uint4(o[0], o[1], o[2], o[3]);
}

// Error codes of this library beside cudaError_t's (which are >= 0).
constexpr int kErrNoEncoder = -1, kErrEncode = -2;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled (its CUDA 12.0 interface), or null.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major [rows, cols] matrix of `elem`-byte values whose
// box is box_rows x box_cols (box_cols * elem = 128 bytes), 128-byte
// swizzled, zeros past the edges.
int encode(CUtensorMap* map, const void* base, CUtensorMapDataType type,
           int elem, int rows, int cols, int box_rows, int box_cols) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

int transpose_s8(const void* B, void* Bt, int K, int N, cudaStream_t st) {
  transpose_s8_kernel<<<dim3(N / kT, K / kT), 256, 0, st>>>(
      static_cast<const uint8_t*>(B), static_cast<uint8_t*>(Bt), K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bt [N, K] = B [K, N]ᵀ, int8, on `stream`.  Returns cudaGetLastError().
extern "C" int cgr_mm_probe_transpose_s8(const void* B, void* Bt, int K,
                                         int N, void* stream) {
  return transpose_s8(B, Bt, K, N, static_cast<cudaStream_t>(stream));
}

// C [M, N] = A [M, K] · B [K, N] on `stream`; int8 when `int8` is 1 (then
// Bt [N, K] is the scratch of B's transpose, launched first), else bf16.
// Returns 0, a cudaError_t, or kErrNoEncoder / kErrEncode.
extern "C" int cgr_mm_probe(const void* A, const void* B, void* Bt, void* C,
                            int M, int N, int K, int int8, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap ta, tb, tc;
  int err;
  if (int8) {
    if ((err = transpose_s8(B, Bt, K, N, st)) != 0) return err;
    if ((err = encode(&ta, A, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, kBM,
                      kRow)) != 0 ||
        (err = encode(&tb, Bt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, kBN,
                      kRow)) != 0)
      return err;
  } else if ((err = encode(&ta, A, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K,
                           kBM, kRow / 2)) != 0 ||
             (err = encode(&tb, B, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, N,
                           kBox16, kBox16)) != 0) {
    return err;
  }
  const CUtensorMapDataType ct = int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if ((err = encode(&tc, C, ct, int8 ? 1 : 2, M, N, kHalf,
                    int8 ? 128 : 64)) != 0)
    return err;
  const auto kernel = int8 ? &mm_kernel<true> : &mm_kernel<false>;
  const int smem = int8 ? kSmemBytes<true> : kSmemBytes<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (M / kBM) * ((N + kBN - 1) / kBN);
  kernel<<<tiles < sms ? tiles : sms, kThreads, smem, st>>>(ta, tb, tc, M, N,
                                                            K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  if (code == kErrNoEncoder)
    return "cuTensorMapEncodeTiled not found through "
           "cudaGetDriverEntryPoint";
  if (code == kErrEncode)
    return "cuTensorMapEncodeTiled refused the operand (alignment or shape)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
