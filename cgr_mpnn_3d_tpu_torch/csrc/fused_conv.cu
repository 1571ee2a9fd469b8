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
//   dpre  = drop'(g)·act'(pre)   ReLU: g·scale where out > 0, linear:
//                                drop'(g) (pallas_fused :280-290, no
//                                second product)
//   dh    = adjoint of the messages applied to dpre·Wᵀ,   dh0 = skip·dpre,
//   dW    = tᵀ·dpre,   db = Σ_r dpre,   dskip = Σ dpre·h0
//
// mat = 1 is the TPU kernels' mat_dtype = out_dtype = bf16 (the model's
// capture path): h, h0, out, the cotangent g, dh and dh0 are bf16, operands
// are rounded to bf16 where they are read, the products run on the tensor
// cores and the mean scale is bf16(1 / degree); dpre, dW, db and dskip stay
// f32 (layered_common.cuh).  With out_f32 the output and its cotangent are
// f32 at mat = 1 (out_dtype f32: the EP overlap path's linear
// pre-activations).  act may be linear (the identity, derivative 1) here
// and in no other kernel.
//
// Design.  One layer of K4 (conv_stack.cu), with h ≠ h0 and Hin ≠ H
// allowed, through the same layered_common.cuh steps: conv_layer (the
// message gather writes t to device scratch, then the product t·W runs as
// one 64 x 64 output tile per block over the whole batch with bias, skip,
// activation and dropout in its epilogue, the pack of a row taken from
// the row index, never from blockIdx), dpre_kernel and conv_layer_bwd.
// The backward recomputes t (and, for mean, each row's scale), takes
// dpre from the saved output (ReLU) or the dropped cotangent (linear),
// with no product, or from the recomputed pre-activation (SiLU, GELU),
// and gathers the adjoint through the transposed ELL array edge_nbr_rev,
// each entry scaled by its forward row's scale, minus the rev row.  dW and db are split-K partials over
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
// scale (K8).  mat = 1 is K6's bf16: h, h0, out, g, dh, dh0 bf16, while r
// and dr stay f32 (the JAX correction is f32); r is rounded to bf16 where
// it enters the sum and s (K9's entries) too, and t = M h + S r is summed
// in f32 and rounded once, before the product with W, as
// pallas_fused.py:458-465 does.  The design and the bound are K6's, with
// the r gather adding tn·Hin reads per pack.

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
// scratch, with each row's scale in rscale when set; then the output (of
// type O) to `out` and the pre-activation to `pre`, each when set.
template <bool kBf16, class O>
void layer(const ConvArgs<kBf16>& a, Elem<kBf16>* t, float* pre, O* out,
           float* rscale, cudaStream_t st) {
  conv_layer<kBf16, O>(a.graph(), a.h, a.Hin, a.w, a.b, a.skip, a.h0, a.H,
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

size_t scratch_bytes(int p, int te, int Hin, int H, int S, int mat) {
  return mat ? scratch_of<true>(nullptr, p, te, Hin, H, S).bytes
             : scratch_of<false>(nullptr, p, te, Hin, H, S).bytes;
}

// out and g are O (the state type, or f32 with out_f32).
template <bool kBf16, class O>
void backward(const ConvArgs<kBf16>& a, const int* edge_nbr_rev,
              const O* out, const O* g, Elem<kBf16>* dh, Elem<kBf16>* dh0,
              float* dw, float* db, float* dskip, void* scratch, int S,
              cudaStream_t st) {
  using E = Elem<kBf16>;
  const Scratch<kBf16> s = scratch_of<kBf16>(scratch, a.p, a.te, a.Hin, a.H,
                                             S);
  // ReLU: dpre from the saved output; linear: the dropped cotangent, no
  // product; SiLU, GELU: from the pre-activation, recomputed into dpre and
  // overwritten in place
  layer<kBf16, E>(a, s.t, needs_pre(a.act) ? s.dpre : nullptr, nullptr,
                  a.mean ? s.rscale : nullptr, st);
  dpre_kernel<O, E, E, O><<<kReduceBlocks, kThreads, 0, st>>>(
      g, needs_pre(a.act) ? s.dpre : nullptr, a.act == kRelu ? out : nullptr,
      s.dpre, a.h0, dh0, 0, a.skip, a.drop, 1, 0, a.act, a.te, a.H,
      a.rows() * a.H, s.dpart);
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

// The edge-partitioned layer's message gather: t = messages(h) plus the
// boundary term of r, each row's scale to rscale (when set).
template <bool kBf16>
void gather_r(const Elem<kBf16>* h, const float* r, const int* edge_nbr,
              const int* rev, const int* senders, const float* scale,
              Elem<kBf16>* t, float* rscale, int p, int te, int tn, int Hin,
              int D, int mean, cudaStream_t st) {
  using E = Elem<kBf16>;
  const long long rows = static_cast<long long>(p) * te;
  launch_gather<kBf16>(GatherArgs<E, E>{h, te, Hin, edge_nbr, D, rev,
                                        nullptr, mean, te, rows, t, rscale,
                                        scale, r, senders, tn},
                       st);
}

template <bool kBf16>
void r_forward(const void* h_, const float* r, const void* h0_,
               const int* edge_nbr, const int* rev, const int* senders,
               const float* scale, const float* w, const float* b,
               const float* skip, const int* drop, void* t_, void* out_,
               int p, int te, int tn, int Hin, int H, int D, int act,
               int mean, cudaStream_t st) {
  using E = Elem<kBf16>;
  E* t = static_cast<E*>(t_);
  gather_r<kBf16>(static_cast<const E*>(h_), r, edge_nbr, rev, senders,
                  scale, t, nullptr, p, te, tn, Hin, D, mean, st);
  launch_tile<kBf16, false, false>(
      plain(t, Hin, w, H, Hin), no_operands(), p * te, H,
      LayerEpi<E>{b, static_cast<const E*>(h0_), skip, act, nullptr,
                  static_cast<E*>(out_), H, drop, 1, 0, te},
      st);
}

template <bool kBf16>
void r_backward(const void* h_, const float* r, const void* h0_,
                const int* edge_nbr, const int* rev, const int* senders,
                const float* scale, const int* edge_nbr_rev,
                const int* node_out, const float* w, const float* b,
                const float* skip, const int* drop, const void* out_,
                const void* g_, void* dh_, float* dr, void* dh0_, float* dw,
                float* db, float* dskip, void* scratch, int p, int te, int tn,
                int Hin, int H, int D, int Dout, int act, int mean, int S,
                cudaStream_t st) {
  using E = Elem<kBf16>;
  const E* h0 = static_cast<const E*>(h0_);
  E* dh = static_cast<E*>(dh_);
  const long long rows = static_cast<long long>(p) * te;
  const Scratch<kBf16> s = scratch_of<kBf16>(scratch, p, te, Hin, H, S);
  gather_r<kBf16>(static_cast<const E*>(h_), r, edge_nbr, rev, senders,
                  scale, s.t, s.rscale, p, te, tn, Hin, D, mean, st);
  // ReLU: dpre from the saved output; linear: the dropped cotangent;
  // SiLU, GELU: from the pre-activation, recomputed into dpre and
  // overwritten in place
  if (needs_pre(act))
    launch_tile<kBf16, false, false>(
        plain(s.t, Hin, w, H, Hin), no_operands(), static_cast<int>(rows), H,
        LayerEpi<E>{b, h0, skip, act, s.dpre, nullptr, H, nullptr, 1, 0, te},
        st);
  dpre_kernel<E, E, E><<<kReduceBlocks, kThreads, 0, st>>>(
      static_cast<const E*>(g_), needs_pre(act) ? s.dpre : nullptr,
      act == kRelu ? static_cast<const E*>(out_) : nullptr, s.dpre, h0,
      static_cast<E*>(dh0_), 0, skip, drop, 1, 0, act, te, H, rows * H,
      s.dpart);
  if (dw != nullptr)
    launch_wgrad<kBf16>(s.t, Hin, s.dpre, H, rows, S, s.wpart, dw, st);
  if (db != nullptr) launch_colsum(s.dpre, H, rows, S, s.wpart, db, st);
  if (dh != nullptr || dr != nullptr)
    launch_tile<kBf16, false, true>(plain(s.dpre, H, w, H, H), no_operands(),
                                    static_cast<int>(rows), Hin,
                                    StoreAs<E>{s.dt, Hin}, st);
  // dh: the messages' adjoint, each entry scaled by its forward row's scale
  // (K9's s, or K8's mean scale), minus the rev row
  if (dh != nullptr)
    launch_gather<kBf16>(GatherArgs<E, E>{
                             s.dt, te, Hin, edge_nbr_rev, D, rev,
                             scale != nullptr ? scale
                                              : (mean ? s.rscale : nullptr),
                             0, te, rows, dh, nullptr},
                         st);
  // dr[n] = Σ over the out-edges e of node n of s_e·dt[e] (f32)
  if (dr != nullptr)
    launch_gather<kBf16>(GatherArgs<E, float>{
                             s.dt, te, Hin, node_out, Dout, nullptr, scale, 0,
                             tn, static_cast<long long>(p) * tn, dr, nullptr},
                         st);
  if (dskip != nullptr) launch_sum(s.dpart, kReduceBlocks, 1, dskip, st);
}

}  // namespace

// out [p·te, H]; t [p·te, Hin] is scratch; h, h0 and t of one type (f32, or
// bf16 with mat = 1), out of that type too unless out_f32.
extern "C" int cgr_fused_conv_fwd(const void* h, const void* h0,
                                  const int* edge_nbr, const int* rev,
                                  const float* w, const float* b,
                                  const float* skip, const int* drop,
                                  void* t, void* out, int p, int te,
                                  int Hin, int H, int D, int act, int mean,
                                  int mat, int out_f32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mat)
    layer<false, float>(args_of<false>(h, h0, edge_nbr, rev, w, b, skip, drop,
                                       p, te, Hin, H, D, act, mean),
                        static_cast<float*>(t), nullptr,
                        static_cast<float*>(out), nullptr, st);
  else if (out_f32)
    layer<true, float>(args_of<true>(h, h0, edge_nbr, rev, w, b, skip, drop,
                                     p, te, Hin, H, D, act, mean),
                       static_cast<Elem<true>*>(t), nullptr,
                       static_cast<float*>(out), nullptr, st);
  else
    layer<true, Elem<true>>(args_of<true>(h, h0, edge_nbr, rev, w, b, skip,
                                          drop, p, te, Hin, H, D, act, mean),
                            static_cast<Elem<true>*>(t), nullptr,
                            static_cast<Elem<true>*>(out), nullptr, st);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the backward's scratch (K6's, and K8/K9's).
extern "C" long long cgr_fused_conv_bwd_scratch_bytes(int p, int te, int Hin,
                                                      int H, int S, int mat) {
  return static_cast<long long>(scratch_bytes(p, te, Hin, H, S, mat));
}

// dh [rows, Hin], dh0 [rows, H] (h's type), dw [Hin, H], db [H], dskip [1]
// from the cotangent g of the forward's output `out` (both of out's type);
// a null output is skipped.
extern "C" int cgr_fused_conv_bwd(
    const void* h, const void* h0, const int* edge_nbr, const int* rev,
    const int* edge_nbr_rev, const float* w, const float* b,
    const float* skip, const int* drop, const void* out, const void* g,
    void* dh, void* dh0, float* dw, float* db, float* dskip, void* scratch,
    int p, int te, int Hin, int H, int D, int act, int mean, int S, int mat,
    int out_f32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using B = Elem<true>;
  if (!mat) {
    backward<false, float>(args_of<false>(h, h0, edge_nbr, rev, w, b, skip,
                                          drop, p, te, Hin, H, D, act, mean),
                           edge_nbr_rev, static_cast<const float*>(out),
                           static_cast<const float*>(g),
                           static_cast<float*>(dh), static_cast<float*>(dh0),
                           dw, db, dskip, scratch, S, st);
  } else if (out_f32) {
    backward<true, float>(args_of<true>(h, h0, edge_nbr, rev, w, b, skip,
                                        drop, p, te, Hin, H, D, act, mean),
                          edge_nbr_rev, static_cast<const float*>(out),
                          static_cast<const float*>(g), static_cast<B*>(dh),
                          static_cast<B*>(dh0), dw, db, dskip, scratch, S,
                          st);
  } else {
    backward<true, B>(args_of<true>(h, h0, edge_nbr, rev, w, b, skip, drop,
                                    p, te, Hin, H, D, act, mean),
                      edge_nbr_rev, static_cast<const B*>(out),
                      static_cast<const B*>(g), static_cast<B*>(dh),
                      static_cast<B*>(dh0), dw, db, dskip, scratch, S, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [p·te, H]; t [p·te, Hin] is scratch; scale [p·te] (K9) or null (K8).
// h, h0, t and out are f32, or bf16 with mat = 1; r is f32.
extern "C" int cgr_fused_conv_r_fwd(const void* h, const float* r,
                                    const void* h0, const int* edge_nbr,
                                    const int* rev, const int* senders,
                                    const float* scale, const float* w,
                                    const float* b, const float* skip,
                                    const int* drop, void* t, void* out,
                                    int p, int te, int tn, int Hin, int H,
                                    int D, int act, int mean, int mat,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  (mat ? r_forward<true> : r_forward<false>)(h, r, h0, edge_nbr, rev, senders,
                                             scale, w, b, skip, drop, t, out,
                                             p, te, tn, Hin, H, D, act, mean,
                                             st);
  return static_cast<int>(cudaGetLastError());
}

// dh [p·te, Hin], dr [p·tn, Hin] (f32), dh0 [p·te, H], dw [Hin, H], db [H],
// dskip [1] from the cotangent g of `out`; a null output is skipped.  h,
// h0, out, g, dh and dh0 are f32, or bf16 with mat = 1.
extern "C" int cgr_fused_conv_r_bwd(
    const void* h, const float* r, const void* h0, const int* edge_nbr,
    const int* rev, const int* senders, const float* scale,
    const int* edge_nbr_rev, const int* node_out, const float* w,
    const float* b, const float* skip, const int* drop, const void* out,
    const void* g, void* dh, float* dr, void* dh0, float* dw, float* db,
    float* dskip, void* scratch, int p, int te, int tn, int Hin, int H, int D,
    int Dout, int act, int mean, int S, int mat, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  (mat ? r_backward<true> : r_backward<false>)(
      h, r, h0, edge_nbr, rev, senders, scale, edge_nbr_rev, node_out, w, b,
      skip, drop, out, g, dh, dr, dh0, dw, db, dskip, scratch, p, te, tn, Hin,
      H, D, Dout, act, mean, S, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
