// Pack-local ELL gather-sum (CUDA C++, sm_90a): K7.
//
// Replaces the TPU kernel cgr_mpnn_3d_tpu/ops/pallas_ops.py::onehot_spmm_t
// (launched through ops/dispatch.py::spmm_t for every gather of the model):
//
//   out[r, :] = Σ_d src[idx[r, d], :]  [− src[sign[r], :]]
//
// with idx [p·R, D] the packer's ELL array, src [p·C, W], and row r of pack
// r / R reading only sources in [pack·C, (pack + 1)·C).  The TPU kernel
// builds a one-hot matrix from transposed index rows and multiplies it on
// the MXU; here a group of lanes walks each output row's ELL entries and
// sums the source rows they name.  Its backward is the same kernel over the
// transposed ELL array (ops/onehot_spmm.py).  mat = 1 is the TPU kernel's
// mat_dtype bf16: every source value is rounded to bf16 as it is read (src
// itself f32, or bf16 when src_bf16), the sums stay f32, and the output is
// f32 -- or bf16 (out_bf16) for a backward whose forward source was bf16,
// one rounding of the f32 sum, as JAX's d_src.astype.
//
// Bound.  The function reads every index once and every gathered source
// row once per entry, and writes the output once: one add per entry and
// column against 4 bytes (2 at bf16) moved, so it is bound by memory bytes
// (3.35 TB/s), not by operations.
//
// Design.  A group of L lanes (L a power of two from 4 to 32, the fewest
// that hold the row's chunks in kSpmmLaneElems columns a lane) owns one
// output row; a block of kSpmmThreads holds kSpmmThreads / L rows, and the
// grid covers every row.  The group reads the row's indices once,
// coalesced, L at a time (lane d entry d); a ballot gives the entries in
// the pack, compacted in ascending d into the warp's shared slots, so an
// all-sentinel row costs one index load a lane and a store of zeros.
// Each lane then reads its chunks of every named source row with the
// widest load that the row width and the alignment of src and out allow
// (16 bytes: 4 f32 or 8 bf16 values; else 8, 4 or 2), neighbouring lanes
// on neighbouring chunks, through the read-only path: all of a lane's
// chunks of an entry (up to kSpmmLaneElems values) in flight before its
// adds.  The rows are short, so what fills the card is warps, not entries
// in flight: one entry at a time, and the registers capped for
// kSpmmBlocksPerSM blocks an SM.  Every column's sum runs in the order of
// layered_common.cuh::gather_elem -- 0, then + each entry in ascending d,
// then − the sign row -- so the output is bit for bit that gather's, at
// f32 and bf16.  No atomics, no split over entries.
//
// Forced builds (the result does not depend on them): -DCGR_SPMM_VEC_BYTES
// caps the load width (e.g. 4), -DCGR_SPMM_LANES fixes the lanes a row (32:
// one row a warp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "fused_model_common.cuh"

#ifndef CGR_SPMM_VEC_BYTES
#define CGR_SPMM_VEC_BYTES 16
#endif
#ifndef CGR_SPMM_LANES
#define CGR_SPMM_LANES 0
#endif

using namespace cgr;

namespace {

constexpr int kSpmmThreads = 256;     // threads of a block
constexpr int kSpmmLaneElems = 16;    // columns a lane sums in one pass
constexpr int kSpmmMinLanes = 4;      // fewest lanes a row
constexpr int kSpmmBlocksPerSM = 4;   // resident blocks the registers allow
constexpr int kSpmmVecBytes = CGR_SPMM_VEC_BYTES;  // widest load
constexpr int kSpmmLanes = CGR_SPMM_LANES;         // 0: sized to the row

static_assert(kSpmmVecBytes == 2 || kSpmmVecBytes == 4 ||
                  kSpmmVecBytes == 8 || kSpmmVecBytes == 16,
              "CGR_SPMM_VEC_BYTES is 2, 4, 8 or 16");
static_assert(kSpmmLanes == 0 || kSpmmLanes == 4 || kSpmmLanes == 8 ||
                  kSpmmLanes == 16 || kSpmmLanes == 32,
              "CGR_SPMM_LANES is 0, 4, 8, 16 or 32");

// The unsigned type of a kBytes-wide load or store.
template <int kBytes>
struct RawOf;
template <>
struct RawOf<16> {
  using T = uint4;
};
template <>
struct RawOf<8> {
  using T = uint2;
};
template <>
struct RawOf<4> {
  using T = unsigned;
};
template <>
struct RawOf<2> {
  using T = unsigned short;
};

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ unsigned word(const uint2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ unsigned word(unsigned v, int) { return v; }
__device__ __forceinline__ unsigned word(unsigned short v, int) { return v; }

// Element i of a loaded vector of S as f32 (a bf16 value exactly: its bits
// in the high half, element 0 in the low half of its word).
template <class S, class R>
__device__ __forceinline__ float element(const R& v, int i) {
  if constexpr (std::is_same_v<S, float>) {
    return __uint_as_float(word(v, i));
  } else {
    const unsigned w = word(v, i / 2);
    return __uint_as_float((i & 1 ? w >> 16 : w & 0xffffu) << 16);
  }
}

// V sums stored at p as O (bf16: round to nearest even), in stores of at
// most 16 bytes.
template <class O, int V>
__device__ __forceinline__ void store(O* p, const float (&v)[V]) {
  if constexpr (std::is_same_v<O, float>) {
    if constexpr (V >= 4) {
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        reinterpret_cast<uint4*>(p)[q] = make_uint4(
            __float_as_uint(v[4 * q]), __float_as_uint(v[4 * q + 1]),
            __float_as_uint(v[4 * q + 2]), __float_as_uint(v[4 * q + 3]));
    } else if constexpr (V == 2) {
      *reinterpret_cast<uint2*>(p) =
          make_uint2(__float_as_uint(v[0]), __float_as_uint(v[1]));
    } else {
      *p = v[0];
    }
  } else {
    if constexpr (V == 1) {
      *reinterpret_cast<unsigned short*>(p) = bf16_bits(v[0]);
    } else {
      unsigned w[V / 2];
#pragma unroll
      for (int q = 0; q < V / 2; ++q)
        w[q] = bf16_bits(v[2 * q]) |
               (static_cast<unsigned>(bf16_bits(v[2 * q + 1])) << 16);
      if constexpr (V == 4)
        *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<unsigned*>(p) = w[0];
    }
  }
}

struct SpmmArgs {
  const void* src;
  const int* idx;
  const int* sign;
  void* out;
  long long rows;  // p·R output rows
  int R, C, W, D;
};

// One output row per group of L = 1 << kLog2L lanes; V elements a chunk.
// Lane gl holds chunks gl, gl + L, ... of each pass, so its loads and
// stores sit at fixed offsets from one address a row.
template <bool kBf16, class S, class O, int V, int kLog2L>
__global__ void __launch_bounds__(kSpmmThreads, kSpmmBlocksPerSM)
    spmm_kernel(const SpmmArgs a) {
  constexpr int L = 1 << kLog2L;
  constexpr int KC = kSpmmLaneElems / V;  // chunks a lane holds in a pass
  constexpr unsigned kBits = L == 32 ? ~0u : (1u << (L % 32)) - 1u;
  using R = typename RawOf<V * static_cast<int>(sizeof(S))>::T;
  __shared__ int slots[kSpmmThreads];
  const int lane = threadIdx.x & 31;
  const int gl = lane & (L - 1);       // lane within the row's group
  const int first = lane & ~(L - 1);   // the group's first lane
  const unsigned group = kBits << first;
  const long long r =
      (static_cast<long long>(blockIdx.x) * kSpmmThreads + threadIdx.x) >>
      kLog2L;
  const bool live = r < a.rows;
  int* my = slots + (threadIdx.x & ~31) + first;
  const S* src = static_cast<const S*>(a.src);
  const long long lo = live ? (r / a.R) * a.C : 0;
  const int* row = a.idx + (live ? r : 0) * a.D;
  const int chunks = a.W / V;
  int js = -1;  // the sign row, when in the pack
  if (live && a.sign != nullptr) {
    const long long j = __ldg(a.sign + r) - lo;
    if (j >= 0 && j < a.C) js = static_cast<int>(lo + j);
  }
  for (int c0 = 0; c0 < chunks; c0 += L * KC) {
    const int c = c0 + gl;  // this lane's first chunk of the pass
    const int nk = c < chunks ? min(KC, (chunks - c + L - 1) >> kLog2L) : 0;
    float acc[KC][V];
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[k][i] = 0.f;
    for (int d0 = 0; d0 < a.D; d0 += L) {
      int j = -1;
      if (live && d0 + gl < a.D) {
        const long long jl = __ldg(row + d0 + gl) - lo;
        if (jl >= 0 && jl < a.C) j = static_cast<int>(lo + jl);
      }
      const unsigned present = __ballot_sync(0xffffffffu, j >= 0) & group;
      if (j >= 0) my[__popc(present & ((1u << lane) - 1u))] = j;
      __syncwarp();
      const int n = __popc(present);
      for (int e = 0; e < n; ++e) {
        const R* s = reinterpret_cast<const R*>(
            src + static_cast<long long>(my[e]) * a.W + c * V);
        R v[KC];
#pragma unroll
        for (int k = 0; k < KC; ++k)
          if (k < nk) v[k] = __ldg(s + k * L);
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          if (k < nk) {
#pragma unroll
            for (int i = 0; i < V; ++i)
              acc[k][i] = acc[k][i] + operand<kBf16>(element<S>(v[k], i));
          }
        }
      }
      __syncwarp();
    }
    if (js >= 0) {
      const R* s = reinterpret_cast<const R*>(
          src + static_cast<long long>(js) * a.W + c * V);
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k < nk) {
          const R v = __ldg(s + k * L);
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[k][i] -= operand<kBf16>(element<S>(v, i));
        }
      }
    }
    if (live) {
      O* o = static_cast<O*>(a.out) + r * a.W + c * V;
#pragma unroll
      for (int k = 0; k < KC; ++k)
        if (k < nk) store<O, V>(o + k * L * V, acc[k]);
    }
  }
}

struct Plan {
  int vec;         // elements a chunk
  int lanes_log2;  // lanes a row
  long long blocks;
};

// The launch plan: the widest chunk (at most kSpmmVecBytes of source, 16
// of output a store) that divides the row and that src and out are aligned
// to; the fewest lanes a row (a power of two, at least kSpmmMinLanes) that
// hold its chunks in kSpmmLaneElems columns a lane, or kSpmmLanes when
// forced; enough blocks for every row.  Mirrored by
// ops/onehot_spmm.py::launch_plan.
Plan plan_of(long long rows, int W, int src_size, int out_size,
             uintptr_t src, uintptr_t out) {
  int vec = 1;
  for (int v = kSpmmVecBytes / src_size; v >= 1; v /= 2) {
    const int ob = v * out_size < 16 ? v * out_size : 16;
    if (v * src_size <= 16 && W % v == 0 && src % (v * src_size) == 0 &&
        out % ob == 0) {
      vec = v;
      break;
    }
  }
  int lanes = kSpmmLanes;
  if (lanes == 0) {
    const int per_lane = kSpmmLaneElems / vec;
    const int need = (W / vec + per_lane - 1) / per_lane;
    lanes = kSpmmMinLanes;
    while (lanes < need && lanes < 32) lanes *= 2;
  }
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes) ++lanes_log2;
  const long long threads = rows << lanes_log2;
  return Plan{vec, lanes_log2, (threads + kSpmmThreads - 1) / kSpmmThreads};
}

template <bool kBf16, class S, class O, int V>
void launch(const SpmmArgs& a, const Plan& plan, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(plan.blocks));
  if (plan.lanes_log2 == 2)
    spmm_kernel<kBf16, S, O, V, 2><<<grid, kSpmmThreads, 0, st>>>(a);
  else if (plan.lanes_log2 == 3)
    spmm_kernel<kBf16, S, O, V, 3><<<grid, kSpmmThreads, 0, st>>>(a);
  else if (plan.lanes_log2 == 4)
    spmm_kernel<kBf16, S, O, V, 4><<<grid, kSpmmThreads, 0, st>>>(a);
  else
    spmm_kernel<kBf16, S, O, V, 5><<<grid, kSpmmThreads, 0, st>>>(a);
}

template <bool kBf16, class S, class O>
void launch_vec(const SpmmArgs& a, const Plan& plan, cudaStream_t st) {
  switch (plan.vec) {
    case 1:
      return launch<kBf16, S, O, 1>(a, plan, st);
    case 2:
      return launch<kBf16, S, O, 2>(a, plan, st);
    case 4:
      return launch<kBf16, S, O, 4>(a, plan, st);
    default:
      if constexpr (sizeof(S) == 2) return launch<kBf16, S, O, 8>(a, plan, st);
  }
}

}  // namespace

// out [p·R, W] (f32, or bf16 with out_bf16 at mat 1 from an f32 src) from
// src [p·C, W] (bf16 with src_bf16 at mat 1), idx [p·R, D], sign [p·R] or
// nullptr: one launch.
extern "C" int cgr_onehot_spmm(const void* src, const int* idx,
                               const int* sign, void* out, int p, int R,
                               int C, int W, int D, int mat, int src_bf16,
                               int out_bf16, void* stream) {
  if ((mat != 0 && mat != 1) || (!mat && (src_bf16 || out_bf16)) ||
      (src_bf16 && out_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(p) * R;
  if (rows == 0 || W == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan plan = plan_of(rows, W, src_bf16 ? 2 : 4, out_bf16 ? 2 : 4,
                            reinterpret_cast<uintptr_t>(src),
                            reinterpret_cast<uintptr_t>(out));
  const SpmmArgs a{src, idx, sign, out, rows, R, C, W, D};
  if (!mat)
    launch_vec<false, float, float>(a, plan, st);
  else if (src_bf16)
    launch_vec<true, __nv_bfloat16, float>(a, plan, st);
  else if (out_bf16)
    launch_vec<true, float, __nv_bfloat16>(a, plan, st);
  else
    launch_vec<true, float, float>(a, plan, st);
  return static_cast<int>(cudaGetLastError());
}

// The plan cgr_onehot_spmm takes for these rows, width, element sizes and
// addresses: plan[0..3] = elements a chunk, lanes a row, rows a block,
// blocks.
extern "C" int cgr_onehot_spmm_plan(long long rows, int W, int src_size,
                                    int out_size, unsigned long long src,
                                    unsigned long long out, long long* plan) {
  const Plan p = plan_of(rows, W, src_size, out_size, src, out);
  plan[0] = p.vec;
  plan[1] = 1 << p.lanes_log2;
  plan[2] = kSpmmThreads >> p.lanes_log2;
  plan[3] = p.blocks;
  return 0;
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
