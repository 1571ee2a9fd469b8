// Pack-local ELL gather-sum (CUDA C++, sm_90a): K7.
//
// Replaces the TPU kernel cgr_mpnn_3d_tpu/ops/pallas_ops.py::onehot_spmm_t
// (launched through ops/dispatch.py::spmm_t for every gather of the model):
//
//   out[r, :] = Σ_d src[idx[r, d], :]  [− src[sign[r], :]]
//
// with idx [p·R, D] the packer's ELL array, src [p·C, H], and row r of pack
// r / R reading only sources in [pack·C, (pack + 1)·C).  The TPU kernel
// builds a one-hot matrix from transposed index rows and multiplies it on
// the MXU; here each thread sums its column of the rows it owns straight
// through the ELL array (layered_common.cuh::gather_kernel).  Its backward
// is the same kernel over the transposed ELL array (ops/onehot_spmm.py).
// mat = 1 is the TPU kernel's mat_dtype bf16: every source value is
// rounded to bf16 as it is read (src itself f32, or bf16 when src_bf16),
// the sums stay f32, and the output is f32 at both types (out_dtype f32 at
// every call site of the model).
//
// Bound.  The function reads every index once and every gathered source
// row once per entry, and writes the output once: D + 1 adds per output
// element, against 4 bytes per element moved (2 for a bf16 source), so it
// is bound by memory bytes (3.35 TB/s), not by operations.  Nothing crosses
// rows, so the grid is rows x column chunks (8 rows x 128 columns a
// block): every SM is busy at any batch, neighbouring threads read
// neighbouring columns.

#include "layered_common.cuh"

using namespace cgr;

namespace {

template <bool kBf16, class S>
void gather(const void* src, const int* idx, const int* sign, float* out,
            int p, int R, int C, int H, int D, cudaStream_t st) {
  launch_gather<kBf16>(GatherArgs<S, float>{static_cast<const S*>(src), C, H,
                                            idx, D, sign, nullptr, 0, R,
                                            static_cast<long long>(p) * R,
                                            out, nullptr},
                       st);
}

}  // namespace

// out [p·R, H] f32 from src [p·C, H], idx [p·R, D], sign [p·R] or nullptr.
extern "C" int cgr_onehot_spmm(const void* src, const int* idx,
                               const int* sign, float* out, int p, int R,
                               int C, int H, int D, int mat, int src_bf16,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mat)
    gather<false, float>(src, idx, sign, out, p, R, C, H, D, st);
  else if (src_bf16)
    gather<true, __nv_bfloat16>(src, idx, sign, out, p, R, C, H, D, st);
  else
    gather<true, float>(src, idx, sign, out, p, R, C, H, D, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
