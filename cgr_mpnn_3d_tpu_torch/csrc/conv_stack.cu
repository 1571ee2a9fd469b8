// The D-MPNN conv stack, forward and backward (CUDA C++, sm_90a): K4.
//
// Replaces the TPU kernels cgr_mpnn_3d_tpu/ops/pallas_stack.py::_fwd_call
// and _bwd_call (fused_conv_stack and its custom VJP).  For l < L, on the
// edge states of p packs of te rows:
//
//   t   = scale·Σ_d h[edge_nbr[:, d]] − h[rev]                 messages
//   h   = drop_l(act(t·W[l] + b[l] + skip[l]·h0)),   h = h0 at l = 0
//
// scale is 1, or 1 / (entries counted) for mean; the rev term stays
// unscaled.  In train mode drop_l is the TPU kernels' hash dropout of the
// pack-local row, column, seed[l] and pack, bit for bit.  The backward
// replays the forward and returns dh0, dW [L, H, H], db [L, H] and dskip [L].
//
// Design.  On the TPU one grid step keeps a pack's edge state in VMEM for
// all L layers.  A te x H f32 state (400 KB at te = 256, H = 400) does not
// fit a block's 227 KB of shared memory, and messages gather rows from all
// over the pack, so here every layer is two grid-wide launches over the
// whole batch: the message gather (layered_common.cuh::gather_kernel) into
// a scratch t, then the product t·W[l] as one 64 x 64 output tile per
// block with bias, skip, activation and dropout in its epilogue
// (LayerEpi, which takes the pack of a row from the row index, never from
// blockIdx).  The launch boundary is the grid-wide barrier that the layer
// dependency needs, and every SM works at any p.  The layer and its
// backward steps are layered_common.cuh's conv_layer, dpre_kernel and
// conv_layer_bwd, which fused_conv.cu (K6, one layer) runs too.
//
// Backward (pallas_stack.py:96-157): the replay keeps every layer's t and
// pre-activation in scratch (2·L·p·te·H floats, 1.4 GB at 436 packs of full
// width), then walks the layers in reverse:
//   dpre_l = drop_l'(g)·act'(pre_l),  dh0 += skip[l]·dpre_l,
//   dskip[l] = Σ dpre_l·h0 (per-block partials, summed in block order),
//   dW[l] = t_lᵀ·dpre_l, db[l] = Σ_r dpre_l (split-K partials, summed in
//   split order), g = adjoint of the messages applied to dpre_l·W[l]ᵀ,
// the adjoint being a gather through edge_nbr_rev (each entry scaled by its
// forward row's 1/degree for mean) minus the rev row, as in
// fused_model_bwd.cu; the stack's input cotangent is dh0 + g.  No float
// atomics: reruns are bit-identical.
//
// Bound.  Per layer 2·rows·H² FMA operations forward (about three times
// that backward, plus the replay) against 3·H·4 bytes per row: bound by
// f32 FMA throughput outside the tensor cores, not by memory.

#include "layered_common.cuh"

namespace {

using namespace cgr;

struct StackArgs {
  const float* h0;
  const int *edge_nbr, *rev;
  const float *w, *b, *skips;
  const int* drop;  // [3, L] dropout table, or nullptr in eval mode
  int p, te, H, L, D, act, mean;
  long long rows() const { return static_cast<long long>(p) * te; }
  ConvGraph graph() const {
    return ConvGraph{edge_nbr, rev, D, mean, te, rows()};
  }
};

// Layer l of the forward (layered_common.cuh::conv_layer): h_out =
// layer(messages(h_in)); the pre-activation goes to `pre` when it is set.
void layer(const StackArgs& a, int l, const float* h_in, float* t, float* pre,
           float* h_out, float* rscale, cudaStream_t st) {
  const size_t HH = static_cast<size_t>(a.H) * a.H;
  conv_layer(a.graph(), h_in, a.H, a.w + l * HH,
             a.b + static_cast<size_t>(l) * a.H, a.skips + l, a.h0, a.H,
             a.act, a.drop, a.L, l, t, pre, h_out, rscale, st);
}

// a += b over n floats.
__global__ void add_kernel(float* a, const float* b, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    a[i] += b[i];
}

}  // namespace

// out [p·te, H] (the last layer's state); t [p·te, H] is scratch.
extern "C" int cgr_conv_stack_fwd(const float* h0, const int* edge_nbr,
                                  const int* rev, const float* w,
                                  const float* b, const float* skips,
                                  const int* drop, float* t, float* out,
                                  int p, int te, int H, int L,
                                  int D, int act, int mean, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StackArgs a{h0, edge_nbr, rev, w, b, skips, drop, p, te, H, L, D, act,
                    mean};
  for (int l = 0; l < L; ++l)
    layer(a, l, l == 0 ? h0 : out, t, nullptr, out, nullptr, st);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the backward's scratch: ts and pres [L, rows, H], h, dt, g
// [rows, H], escale [rows], the weight partials [S, H, H] and the dskip
// partials [kReduceBlocks, L].
extern "C" long long cgr_conv_stack_bwd_scratch_floats(int p, int te, int H,
                                                       int L, int S) {
  const long long rH = static_cast<long long>(p) * te * H;
  return (2LL * L + 3) * rH + static_cast<long long>(p) * te +
         static_cast<long long>(S) * H * H +
         static_cast<long long>(kReduceBlocks) * L;
}

// dh0 [rows, H], dw [L, H, H], db [L, H], dskip [L] from the cotangent g of
// the forward's output.
extern "C" int cgr_conv_stack_bwd(const float* h0, const int* edge_nbr,
                                  const int* rev, const int* edge_nbr_rev,
                                  const float* w, const float* b,
                                  const float* skips, const int* drop,
                                  const float* g_out, float* dh0, float* dw,
                                  float* db, float* dskip, float* scratch,
                                  int p, int te, int H, int L, int D, int act,
                                  int mean, int S, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StackArgs a{h0, edge_nbr, rev, w, b, skips, drop, p, te, H, L, D, act,
                    mean};
  const long long rows = a.rows(), rH = rows * H;
  const size_t HH = static_cast<size_t>(H) * H;
  float* ts = scratch;
  float* pres = ts + L * rH;
  float* h = pres + L * rH;
  float* dt = h + rH;
  float* g = dt + rH;
  float* escale = g + rH;
  float* wpart = escale + rows;
  float* dpart = wpart + static_cast<long long>(S) * HH;

  // replay, keeping every layer's messages and pre-activations
  for (int l = 0; l < L; ++l)
    layer(a, l, l == 0 ? h0 : h, ts + l * rH, pres + l * rH, h,
          l == 0 ? escale : nullptr, st);

  const float* g_in = g_out;
  const ConvGraph gr = a.graph();
  for (int l = L - 1; l >= 0; --l) {
    float* dpre = pres + l * rH;
    dpre_kernel<<<kReduceBlocks, kThreads, 0, st>>>(
        g_in, dpre, nullptr, dpre, h0, dh0, l < L - 1, skips + l, drop, L, l,
        act, te, H, rH, dpart);
    // dW[l], db[l], and g = the messages' adjoint applied to dpre·W[l]ᵀ
    conv_layer_bwd(gr, edge_nbr_rev, ts + l * rH, H, dpre, H, w + l * HH,
                   escale, S, wpart, dt, g, dw + l * HH,
                   db + static_cast<size_t>(l) * H, st);
    g_in = g;
  }
  add_kernel<<<2048, 256, 0, st>>>(dh0, g_in, rH);
  launch_sum(dpart, kReduceBlocks, L, dskip, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
