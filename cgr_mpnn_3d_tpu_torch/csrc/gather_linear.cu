// Gather-linear, forward and backward (CUDA C++, sm_90a): K5.
//
// Replaces the TPU kernels cgr_mpnn_3d_tpu/ops/pallas_glin.py::_fwd_call
// and _bwd_call (fused_gather_linear and its custom VJP):
//
//   out = act((G·xa)·Wa + xb·Wb + b),   (G·xa)[r] = scale_r·Σ_d xa[idx[r, d]]
//
// over p packs of R output rows, xa [p·ca, FA] gathered pack-locally, xb
// [p·R, FB]; scale_r is 1, or 1 / (entries counted) for mean.  The model
// uses it twice: edge_init (idx = senders, xa = x, xb = e) and the readout
// (idx = node_inc, xa = h, xb = x).  The backward returns dxa, dxb, dWa,
// dWb and db (any of them skipped when its pointer is null):
//
//   dpre = g·act'(pre)          ReLU: g where out > 0 (pallas_glin.py:88)
//   dxb  = dpre·Wbᵀ,  dxa = Gᵀ·(dpre·Waᵀ),  dWa = (G·xa)ᵀ·dpre,
//   dWb  = xbᵀ·dpre,  db = Σ_r dpre
//
// Design.  The TPU kernel builds G as a one-hot matrix per pack and keeps
// every operand of a pack in VMEM.  Here:
// * the gathered operand t1 = G·xa is written once to device scratch by a
//   grid-wide gather (layered_common.cuh::gather_kernel), then the products
//   run as one 64 x 64 output tile per block over the whole batch (the f32
//   FMA loop of fused_model_common.cuh), so every SM works at any p;
// * Gᵀ is a gather through the transposed ELL array `adj` [p·ca, Dadj]
//   (node_out for edge_init, receivers for the readout), each entry scaled
//   by its forward row's scale_r (kept by the forward gather): no atomics;
// * the weight gradients are split-K products: S partials over fixed row
//   ranges, summed in split order by a second launch, so reruns are
//   bit-identical.
//
// Bound.  Per call the products need 2·rows·(FA + FB)·H FMA operations
// (forward; about three times that backward) against a few hundred bytes
// per row, so at the model's widths (FA, FB, H ≥ 14, H = 400) the kernel is
// bound by f32 FMA throughput outside the tensor cores (67 TFLOP/s), not
// by memory.  The tile loop is the simple one of fused_model_common.cuh (no
// wgmma, no TMA).

#include "layered_common.cuh"

namespace {

using namespace cgr;

// dpre = g·act'(acc + bias): the backward's pre-activation recomputed.
struct DpreEpi {
  const float* bias;
  const float* g;
  int act;
  float* dpre;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    const size_t o = static_cast<size_t>(m) * ld + n;
    dpre[o] = g[o] * k_dact(act, acc + bias[n]);
  }
};

// ReLU: dpre = g where out > 0, else 0.
__global__ void relu_dpre_kernel(const float* out, const float* g, long long n,
                                 float* dpre) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    dpre[i] = out[i] > 0.f ? g[i] : 0.f;
}

struct Dims {
  int p, R, ca, FA, FB, H, D, act, mean;
  long long rows() const { return static_cast<long long>(p) * R; }
};

// t1 = G·xa into scratch, with each forward row's scale in rscale (when
// set).
void gather_t1(const float* xa, const int* idx, const Dims& d, float* t1,
               float* rscale, cudaStream_t st) {
  launch_gather(GatherArgs{xa, d.ca, d.FA, idx, d.D, nullptr, nullptr, d.mean,
                           d.R, d.rows(), t1, rscale},
                st);
}

}  // namespace

// out [p·R, H]; t1 [p·R, FA] is scratch.
extern "C" int cgr_gather_linear_fwd(const float* xa, const float* xb,
                                     const int* idx, const float* wa,
                                     const float* wb, const float* b,
                                     float* t1, float* out, int p, int R,
                                     int ca, int FA, int FB, int H, int D,
                                     int act, int mean, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{p, R, ca, FA, FB, H, D, act, mean};
  gather_t1(xa, idx, d, t1, nullptr, st);
  const int M = static_cast<int>(d.rows());
  launch_tile<false, false>(
      plain(t1, FA, wa, H, FA), plain(xb, FB, wb, H, FB), M, H,
      LayerEpi{b, nullptr, nullptr, act, nullptr, out, H, nullptr, 0, 0, R},
      st);
  return static_cast<int>(cudaGetLastError());
}

// Cotangents from g [p·R, H] (the forward's output `out` given): dxa [p·ca,
// FA] through adj [p·ca, Dadj], dxb [p·R, FB], dwa [FA, H], dwb [FB, H],
// db [H]; a null output is skipped.  Scratch: t1 and dt [p·R, FA], dpre
// [p·R, H], rscale [p·R], part [S·max(FA, FB)·H].
extern "C" int cgr_gather_linear_bwd(
    const float* xa, const float* xb, const int* idx, const int* adj,
    const float* wa, const float* wb, const float* b, const float* out,
    const float* g, float* dxa, float* dxb, float* dwa, float* dwb, float* db,
    float* t1, float* dt, float* dpre, float* rscale, float* part, int p,
    int R, int ca, int FA, int FB, int H, int D, int Dadj, int act, int mean,
    int S, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{p, R, ca, FA, FB, H, D, act, mean};
  const long long rows = d.rows();
  const int M = static_cast<int>(rows);
  gather_t1(xa, idx, d, t1, rscale, st);
  if (act == kRelu) {
    relu_dpre_kernel<<<2048, 256, 0, st>>>(out, g, rows * H, dpre);
  } else {
    launch_tile<false, false>(plain(t1, FA, wa, H, FA),
                              plain(xb, FB, wb, H, FB), M, H,
                              DpreEpi{b, g, act, dpre, H}, st);
  }
  const Operands none = no_operands();
  if (dxb != nullptr)
    launch_tile<false, true>(plain(dpre, H, wb, H, H), none, M, FB,
                             StoreEpi{dxb, FB}, st);
  if (dxa != nullptr) {
    launch_tile<false, true>(plain(dpre, H, wa, H, H), none, M, FA,
                             StoreEpi{dt, FA}, st);
    launch_gather(GatherArgs{dt, R, FA, adj, Dadj, nullptr,
                             mean ? rscale : nullptr, 0, ca,
                             static_cast<long long>(p) * ca, dxa, nullptr},
                  st);
  }
  if (dwa != nullptr) launch_wgrad(t1, FA, dpre, H, rows, S, part, dwa, st);
  if (dwb != nullptr) launch_wgrad(xb, FB, dpre, H, rows, S, part, dwb, st);
  if (db != nullptr) launch_colsum(dpre, H, rows, S, part, db, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
