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
// mat = 1 is the TPU kernels' mat_dtype = out_dtype = bf16 (the model's
// capture path): h, h0, out, the cotangent g, dh and dh0 are bf16, operands
// are rounded to bf16 where they are read, the products run on the tensor
// cores and the mean scale is bf16(1 / degree); dpre, dW, db and dskip stay
// f32 (layered_common.cuh).
//
// Design.  One layer of K4 (conv_stack.cu), with h ≠ h0 and Hin ≠ H
// allowed, through the same layered_common.cuh steps: conv_layer (the
// message gather writes t to device scratch, then the product t·W runs as
// one 64 x 64 output tile per block over the whole batch with bias, skip,
// activation and dropout in its epilogue, the pack of a row taken from
// the row index, never from blockIdx), dpre_kernel and conv_layer_bwd.
// The backward recomputes t (and, for mean, each row's scale), takes
// dpre from the saved output (ReLU, no product) or from the recomputed
// pre-activation (SiLU, GELU), and gathers the adjoint through the
// transposed ELL array edge_nbr_rev, each entry scaled by its forward
// row's scale, minus the rev row.  dW and db are split-K partials over
// fixed row ranges, dskip per-block partials, each summed in order by a
// second launch: no float atomics, so reruns are bit-identical.
//
// Bound.  2·rows·Hin·H multiply-adds forward against (Hin + 2·H) elements
// per row (about three times the operations backward): at the model's
// widths (H = 400) bound by the products -- f32 FMA throughput outside the
// tensor cores, or the bf16 tensor-core rate -- not by memory.  The tile
// loop is the simple one of fused_model_common.cuh (no wgmma, no TMA).
//
// The edge-partitioned layer (K8, and K9 with the global mean scale), the
// entry points cgr_fused_conv_r_*: the TPU kernels
// pallas_fused.py::_fwd_call_r and _bwd_call_r (fused_conv_layer_r and
// fused_conv_layer_rm), run once per wired layer by parallel/ep_pack.py.
// The messages take one more term, the boundary correction r [p·tn, Hin]
// (f32) of the layer's node slots, gathered at the edge's sender:
//
//   t[e] = s_e·(Σ_d h[edge_nbr[e, d]] + r[senders[e]]) − h[rev e]   (K9)
//   t[e] = scale·Σ_d h[edge_nbr[e, d]] − h[rev e] + r[senders[e]]    (K8)
//
// with s the given per-edge global 1/in-degree of the sender (0 on
// padding) and K8's scale 1, or the local mean scale; then K6's epilogue.
// The backward adds dr[n] = Σ_{e ∈ node_out[n]} s_e·dt[e] (K8: s = 1), a
// gather through node_out with no atomics, and takes dh through
// edge_nbr_rev with each entry scaled by s (K9) or the forward row's mean
// scale (K8).  f32 only (mat_dtype f32); the design and the bound are
// K6's, with the r gather adding tn·Hin reads per pack.

#include "layered_common.cuh"

namespace {

using namespace cgr;

template <bool kBf16>
struct ConvArgs {
  const Elem<kBf16> *h, *h0;
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
template <bool kBf16>
void layer(const ConvArgs<kBf16>& a, Elem<kBf16>* t, float* pre,
           Elem<kBf16>* out, float* rscale, cudaStream_t st) {
  conv_layer<kBf16>(a.graph(), a.h, a.Hin, a.w, a.b, a.skip, a.h0, a.H,
                    a.act, a.drop, 1, 0, t, pre, out, rscale, st);
}

// The backward's scratch: t and dt [rows, Hin] as Elem; dpre [rows, H],
// rscale [rows], the split-K partials [S, Hin, H] and the dskip partials
// [kReduceBlocks] as f32.
template <bool kBf16>
struct Scratch {
  Elem<kBf16> *t, *dt;
  float *dpre, *rscale, *wpart, *dpart;
  size_t bytes;
};

template <bool kBf16>
Scratch<kBf16> scratch_of(void* base, int p, int te, int Hin, int H, int S) {
  using E = Elem<kBf16>;
  const long long rows = static_cast<long long>(p) * te;
  Carve c{static_cast<char*>(base)};
  Scratch<kBf16> s;
  s.t = c.take<E>(rows * Hin);
  s.dt = c.take<E>(rows * Hin);
  s.dpre = c.take<float>(rows * H);
  s.rscale = c.take<float>(rows);
  s.wpart = c.take<float>(static_cast<long long>(S) * Hin * H);
  s.dpart = c.take<float>(kReduceBlocks);
  s.bytes = c.used;
  return s;
}

template <bool kBf16>
void backward(const ConvArgs<kBf16>& a, const int* edge_nbr_rev,
              const Elem<kBf16>* out, const Elem<kBf16>* g, Elem<kBf16>* dh,
              Elem<kBf16>* dh0, float* dw, float* db, float* dskip,
              void* scratch, int S, cudaStream_t st) {
  using E = Elem<kBf16>;
  const Scratch<kBf16> s = scratch_of<kBf16>(scratch, a.p, a.te, a.Hin, a.H,
                                             S);
  // ReLU: dpre from the saved output; SiLU, GELU: from the pre-activation,
  // recomputed into dpre and overwritten in place
  layer(a, s.t, a.act == kRelu ? nullptr : s.dpre, nullptr,
        a.mean ? s.rscale : nullptr, st);
  dpre_kernel<E, E, E><<<kReduceBlocks, kThreads, 0, st>>>(
      g, s.dpre, a.act == kRelu ? out : nullptr, s.dpre, a.h0, dh0, 0,
      a.skip, a.drop, 1, 0, a.act, a.te, a.H, a.rows() * a.H, s.dpart);
  conv_layer_bwd<kBf16>(a.graph(), edge_nbr_rev, s.t, a.Hin, s.dpre, a.H,
                        a.w, s.rscale, S, s.wpart, s.dt, dh, dw, db, st);
  if (dskip != nullptr) launch_sum(s.dpart, kReduceBlocks, 1, dskip, st);
}

template <bool kBf16>
ConvArgs<kBf16> args_of(const void* h, const void* h0, const int* edge_nbr,
                        const int* rev, const float* w, const float* b,
                        const float* skip, const int* drop, int p, int te,
                        int Hin, int H, int D, int act, int mean) {
  using E = Elem<kBf16>;
  return ConvArgs<kBf16>{static_cast<const E*>(h), static_cast<const E*>(h0),
                         edge_nbr, rev, w, b, skip, drop, p, te, Hin, H, D,
                         act, mean};
}

}  // namespace

// out [p·te, H]; t [p·te, Hin] is scratch; h, h0, t and out of one type
// (f32, or bf16 with mat = 1).
extern "C" int cgr_fused_conv_fwd(const void* h, const void* h0,
                                  const int* edge_nbr, const int* rev,
                                  const float* w, const float* b,
                                  const float* skip, const int* drop,
                                  void* t, void* out, int p, int te,
                                  int Hin, int H, int D, int act, int mean,
                                  int mat, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mat)
    layer(args_of<true>(h, h0, edge_nbr, rev, w, b, skip, drop, p, te, Hin,
                        H, D, act, mean),
          static_cast<Elem<true>*>(t), nullptr, static_cast<Elem<true>*>(out),
          nullptr, st);
  else
    layer(args_of<false>(h, h0, edge_nbr, rev, w, b, skip, drop, p, te, Hin,
                         H, D, act, mean),
          static_cast<float*>(t), nullptr, static_cast<float*>(out), nullptr,
          st);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the backward's scratch.
extern "C" long long cgr_fused_conv_bwd_scratch_bytes(int p, int te, int Hin,
                                                      int H, int S, int mat) {
  return static_cast<long long>(
      mat ? scratch_of<true>(nullptr, p, te, Hin, H, S).bytes
          : scratch_of<false>(nullptr, p, te, Hin, H, S).bytes);
}

// dh [rows, Hin], dh0 [rows, H] (h's type), dw [Hin, H], db [H], dskip [1]
// from the cotangent g of the forward's output `out` (h's type); a null
// output is skipped.
extern "C" int cgr_fused_conv_bwd(
    const void* h, const void* h0, const int* edge_nbr, const int* rev,
    const int* edge_nbr_rev, const float* w, const float* b,
    const float* skip, const int* drop, const void* out, const void* g,
    void* dh, void* dh0, float* dw, float* db, float* dskip, void* scratch,
    int p, int te, int Hin, int H, int D, int act, int mean, int S, int mat,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mat) {
    using E = Elem<true>;
    backward(args_of<true>(h, h0, edge_nbr, rev, w, b, skip, drop, p, te, Hin,
                           H, D, act, mean),
             edge_nbr_rev, static_cast<const E*>(out),
             static_cast<const E*>(g), static_cast<E*>(dh),
             static_cast<E*>(dh0), dw, db, dskip, scratch, S, st);
  } else {
    backward(args_of<false>(h, h0, edge_nbr, rev, w, b, skip, drop, p, te,
                            Hin, H, D, act, mean),
             edge_nbr_rev, static_cast<const float*>(out),
             static_cast<const float*>(g), static_cast<float*>(dh),
             static_cast<float*>(dh0), dw, db, dskip, scratch, S, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The edge-partitioned layer's message gather: t = messages(h) plus the
// boundary term of r, each row's scale to rscale (when set).
static void gather_r(const float* h, const float* r, const int* edge_nbr,
              const int* rev, const int* senders, const float* scale,
              float* t, float* rscale, int p, int te, int tn, int Hin, int D,
              int mean, cudaStream_t st) {
  const long long rows = static_cast<long long>(p) * te;
  launch_gather<false>(GatherArgs<float, float>{h, te, Hin, edge_nbr, D, rev,
                                                nullptr, mean, te, rows, t,
                                                rscale, scale, r, senders,
                                                tn},
                       st);
}

// out [p·te, H]; t [p·te, Hin] is scratch; scale [p·te] (K9) or null (K8).
extern "C" int cgr_fused_conv_r_fwd(const float* h, const float* r,
                                    const float* h0, const int* edge_nbr,
                                    const int* rev, const int* senders,
                                    const float* scale, const float* w,
                                    const float* b, const float* skip,
                                    const int* drop, float* t, float* out,
                                    int p, int te, int tn, int Hin, int H,
                                    int D, int act, int mean, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  gather_r(h, r, edge_nbr, rev, senders, scale, t, nullptr, p, te, tn, Hin,
           D, mean, st);
  launch_tile<false, false, false>(
      plain(t, Hin, w, H, Hin), no_operands(), p * te, H,
      LayerEpi<float>{b, h0, skip, act, nullptr, out, H, drop, 1, 0, te}, st);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the edge-partitioned backward's scratch (K6's at f32).
extern "C" long long cgr_fused_conv_r_bwd_scratch_bytes(int p, int te,
                                                        int Hin, int H,
                                                        int S) {
  return static_cast<long long>(
      scratch_of<false>(nullptr, p, te, Hin, H, S).bytes);
}

// dh [p·te, Hin], dr [p·tn, Hin], dh0 [p·te, H], dw [Hin, H], db [H],
// dskip [1] from the cotangent g of `out`; a null output is skipped.
extern "C" int cgr_fused_conv_r_bwd(
    const float* h, const float* r, const float* h0, const int* edge_nbr,
    const int* rev, const int* senders, const float* scale,
    const int* edge_nbr_rev, const int* node_out, const float* w,
    const float* b, const float* skip, const int* drop, const float* out,
    const float* g, float* dh, float* dr, float* dh0, float* dw, float* db,
    float* dskip, void* scratch, int p, int te, int tn, int Hin, int H, int D,
    int Dout, int act, int mean, int S, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(p) * te;
  const Scratch<false> s = scratch_of<false>(scratch, p, te, Hin, H, S);
  gather_r(h, r, edge_nbr, rev, senders, scale, s.t, s.rscale, p, te, tn,
           Hin, D, mean, st);
  // ReLU: dpre from the saved output; SiLU, GELU: from the pre-activation,
  // recomputed into dpre and overwritten in place
  if (act != kRelu)
    launch_tile<false, false, false>(
        plain(s.t, Hin, w, H, Hin), no_operands(), static_cast<int>(rows), H,
        LayerEpi<float>{b, h0, skip, act, s.dpre, nullptr, H, nullptr, 1, 0,
                        te},
        st);
  dpre_kernel<float, float, float><<<kReduceBlocks, kThreads, 0, st>>>(
      g, s.dpre, act == kRelu ? out : nullptr, s.dpre, h0, dh0, 0, skip, drop,
      1, 0, act, te, H, rows * H, s.dpart);
  if (dw != nullptr)
    launch_wgrad<false>(s.t, Hin, s.dpre, H, rows, S, s.wpart, dw, st);
  if (db != nullptr) launch_colsum(s.dpre, H, rows, S, s.wpart, db, st);
  if (dh != nullptr || dr != nullptr)
    launch_tile<false, false, true>(plain(s.dpre, H, w, H, H), no_operands(),
                                    static_cast<int>(rows), Hin,
                                    StoreAs<float>{s.dt, Hin}, st);
  // dh: the messages' adjoint, each entry scaled by its forward row's scale
  // (K9's s, or K8's mean scale), minus the rev row
  if (dh != nullptr)
    launch_gather<false>(GatherArgs<float, float>{
                             s.dt, te, Hin, edge_nbr_rev, D, rev,
                             scale != nullptr ? scale
                                              : (mean ? s.rscale : nullptr),
                             0, te, rows, dh, nullptr},
                         st);
  // dr[n] = Σ over the out-edges e of node n of s_e·dt[e]
  if (dr != nullptr)
    launch_gather<false>(GatherArgs<float, float>{
                             s.dt, te, Hin, node_out, Dout, nullptr, scale, 0,
                             tn, static_cast<long long>(p) * tn, dr, nullptr},
                         st);
  if (dskip != nullptr) launch_sum(s.dpart, kReduceBlocks, 1, dskip, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
