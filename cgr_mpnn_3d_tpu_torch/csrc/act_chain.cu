// Activation-chain probe (CUDA C++, sm_90a): P1.
//
// Replaces the TPU probe tools/gelu_roofline.py::main.pallas_chain (one
// Pallas kernel that loads a [TE, H] tile, applies an activation k times in
// registers and stores it).  Here one launch applies
//
//   y = fn(0.5·y) − 0.1,   k times,
//
// to every element of an [N, H] f32 array, with fn one of relu, silu, gelu
// (k_act), gelu_bwd (k_dact of gelu) or gelu_bwd_from_out
// (gelu(y) / y + y·pdf(y), 0.5 + y·pdf(y) where |y| ≤ 1e-6).  k_act and
// k_dact are the __device__ functions of fused_model_common.cuh that the
// kernels K3f, K2, K3b, K4, K5 and K6 inline, so the probe times the chain
// those kernels run.  They take CUDA's erff, where the TPU kernels build
// erf from exp (Abramowitz-Stegun 7.1.26): this probe times the port's
// chain, not the TPU's.
//
// Design.  A grid-stride loop over elements, each thread keeping its value
// in a register for the whole chain; k is a runtime argument so the chain
// cannot be folded, and fn a template argument so no branch sits inside
// it.  The slope of the time over k gives the time per application; at
// k = 1 the launch reads and writes every element once, so it is bound by
// memory bytes (3.35 TB/s).

#include "fused_model_common.cuh"

namespace {

using namespace cgr;

enum Fn { kFnRelu = 0, kFnSilu, kFnGelu, kFnGeluBwd, kFnGeluBwdFromOut };

template <int FN>
__device__ __forceinline__ float apply_fn(float y) {
  if (FN == kFnRelu) return k_act(kRelu, y);
  if (FN == kFnSilu) return k_act(kSilu, y);
  if (FN == kFnGelu) return k_act(kGelu, y);
  if (FN == kFnGeluBwd) return k_dact(kGelu, y);
  const float cdf = fabsf(y) > 1e-6f ? k_act(kGelu, y) / y : 0.5f;
  return cdf + y * 0.3989422804014327f * expf(-y * y * 0.5f);
}

template <int FN>
__global__ void chain_kernel(const float* __restrict__ x,
                             float* __restrict__ y, long long n, int k) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = x[i];
    for (int j = 0; j < k; ++j) v = apply_fn<FN>(v * 0.5f) - 0.1f;
    y[i] = v;
  }
}

template <int FN>
void launch(const float* x, float* y, long long n, int k, cudaStream_t st) {
  const long long blocks = (n + 255) / 256 < 132 * 16 ? (n + 255) / 256
                                                      : 132 * 16;
  chain_kernel<FN><<<static_cast<int>(blocks), 256, 0, st>>>(x, y, n, k);
}

}  // namespace

// y [n] = the chain of fn applied k times to x [n]; fn as in Fn.
extern "C" int cgr_act_chain(const float* x, float* y, long long n, int fn,
                             int k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    switch (fn) {
      case kFnRelu: launch<kFnRelu>(x, y, n, k, st); break;
      case kFnSilu: launch<kFnSilu>(x, y, n, k, st); break;
      case kFnGelu: launch<kFnGelu>(x, y, n, k, st); break;
      case kFnGeluBwd: launch<kFnGeluBwd>(x, y, n, k, st); break;
      case kFnGeluBwdFromOut: launch<kFnGeluBwdFromOut>(x, y, n, k, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
