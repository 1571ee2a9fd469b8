// One D-MPNN conv layer, forward and backward (CUDA C++, sm_90a): K6.
//
// Replaces the TPU kernels cgr_mpnn_3d_tpu/ops/pallas_fused.py::_fwd_call
// and _bwd_call (fused_conv_layer and its custom VJP), which capture mode
// runs once per layer.  On the edge states of p packs of te rows:
//
//   t   = scale·Σ_d h[edge_nbr[:, d]] − h[rev]                 messages
//   out = drop(act(t·W + b + skip·h0))
//
// with h [rows, Hin], W [Hin, H], h0 and out [rows, H], skip one float on
// the card.  scale is 1, or 1 / (entries counted) for mean; the rev term
// stays unscaled.  In train mode drop is the TPU kernels' hash dropout of
// the pack-local row, column, seed and pack, bit for bit.  The backward
// returns dh [rows, Hin], dh0, dW, db and dskip (any of them skipped when
// its pointer is null):
//
//   dpre  = drop'(g)·act'(pre)   ReLU: g·scale where out > 0 (pallas_fused
//                                :280-284, no second product)
//   dh    = adjoint of the messages applied to dpre·Wᵀ,   dh0 = skip·dpre,
//   dW    = tᵀ·dpre,   db = Σ_r dpre,   dskip = Σ dpre·h0
//
// Design.  One layer of K4 (conv_stack.cu), with h ≠ h0 and Hin ≠ H
// allowed, through the same layered_common.cuh steps: conv_layer (the
// message gather writes t to device scratch, then the product t·W runs as
// one 64 x 64 output tile per block over the whole batch with bias, skip,
// activation and dropout in its epilogue, the pack of a row taken from
// the row index, never from blockIdx), dpre_kernel and conv_layer_bwd.
// The backward recomputes t (and, for mean, each row's 1/degree), takes
// dpre from the saved output (ReLU, no product) or from the recomputed
// pre-activation (SiLU, GELU), and gathers the adjoint through the
// transposed ELL array edge_nbr_rev, each entry scaled by its forward
// row's 1/degree, minus the rev row.  dW and db are split-K partials over
// fixed row ranges, dskip per-block partials, each summed in order by a
// second launch: no float atomics, so reruns are bit-identical.
//
// Bound.  2·rows·Hin·H FMA operations forward against (Hin + 2·H)·4 bytes
// per row (about three times the operations backward): at the model's
// widths (H = 400) bound by f32 FMA throughput outside the tensor cores,
// not by memory.  The tile loop is the simple one of fused_model_common.cuh
// (no wgmma, no TMA).

#include "layered_common.cuh"

namespace {

using namespace cgr;

struct ConvArgs {
  const float *h, *h0;
  const int *edge_nbr, *rev;
  const float *w, *b, *skip;
  const int* drop;  // [3, 1] dropout table, or nullptr in eval mode
  int p, te, Hin, H, D, act, mean;
  long long rows() const { return static_cast<long long>(p) * te; }
  ConvGraph graph() const {
    return ConvGraph{edge_nbr, rev, D, mean, te, rows()};
  }
};

// The layer (layered_common.cuh::conv_layer): t = messages(h) into
// scratch, with each row's scale in rscale when set; then the output to
// `out` and the pre-activation to `pre`, each when set.
void layer(const ConvArgs& a, float* t, float* pre, float* out,
           float* rscale, cudaStream_t st) {
  conv_layer(a.graph(), a.h, a.Hin, a.w, a.b, a.skip, a.h0, a.H, a.act,
             a.drop, 1, 0, t, pre, out, rscale, st);
}

}  // namespace

// out [p·te, H]; t [p·te, Hin] is scratch.
extern "C" int cgr_fused_conv_fwd(const float* h, const float* h0,
                                  const int* edge_nbr, const int* rev,
                                  const float* w, const float* b,
                                  const float* skip, const int* drop,
                                  float* t, float* out, int p, int te,
                                  int Hin, int H, int D, int act, int mean,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  layer(ConvArgs{h, h0, edge_nbr, rev, w, b, skip, drop, p, te, Hin, H, D,
                 act, mean},
        t, nullptr, out, nullptr, st);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the backward's scratch: t and dt [rows, Hin], dpre [rows, H],
// rscale [rows], the split-K partials [S, Hin, H] and the dskip partials
// [kReduceBlocks].
extern "C" long long cgr_fused_conv_bwd_scratch_floats(int p, int te, int Hin,
                                                      int H, int S) {
  const long long rows = static_cast<long long>(p) * te;
  return rows * (2LL * Hin + H + 1) + static_cast<long long>(S) * Hin * H +
         kReduceBlocks;
}

// dh [rows, Hin], dh0 [rows, H], dw [Hin, H], db [H], dskip [1] from the
// cotangent g of the forward's output `out`; a null output is skipped.
extern "C" int cgr_fused_conv_bwd(
    const float* h, const float* h0, const int* edge_nbr, const int* rev,
    const int* edge_nbr_rev, const float* w, const float* b,
    const float* skip, const int* drop, const float* out, const float* g,
    float* dh, float* dh0, float* dw, float* db, float* dskip, float* scratch,
    int p, int te, int Hin, int H, int D, int act, int mean, int S,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ConvArgs a{h, h0, edge_nbr, rev, w, b, skip, drop, p, te, Hin, H, D,
                   act, mean};
  const long long rows = a.rows();
  float* t = scratch;
  float* dt = t + rows * Hin;
  float* dpre = dt + rows * Hin;
  float* rscale = dpre + rows * H;
  float* wpart = rscale + rows;
  float* dpart = wpart + static_cast<long long>(S) * Hin * H;

  // ReLU: dpre from the saved output; SiLU, GELU: from the pre-activation,
  // recomputed into dpre and overwritten in place
  layer(a, t, act == kRelu ? nullptr : dpre, nullptr, mean ? rscale : nullptr,
        st);
  dpre_kernel<<<kReduceBlocks, kThreads, 0, st>>>(
      g, dpre, act == kRelu ? out : nullptr, dpre, h0, dh0, 0, skip, drop, 1,
      0, act, te, H, rows * H, dpart);
  conv_layer_bwd(a.graph(), edge_nbr_rev, t, Hin, dpre, H, w, rscale, S,
                 wpart, dt, dh, dw, db, st);
  if (dskip != nullptr) launch_sum(dpart, kReduceBlocks, 1, dskip, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
