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
// Design (conv_grid.cuh).  Each direction is one cooperative launch over
// the whole card, phases behind grid barriers: forward the message gather
// (t to device scratch) then the product t·W as tiles over the whole
// batch with bias, skip, activation and dropout in their epilogue (the
// pack of a row taken from the row index, never from blockIdx); backward
// the recomputed t (and, for mean, each row's scale; for SiLU and GELU the
// pre-activation tiles), dpre from the saved output (ReLU), the dropped
// cotangent (linear) or the pre-activation (SiLU, GELU) with dh0 and the
// dskip partials, then dW's split-K partial tiles, db's column partials
// and the tiles of dt = dpre·Wᵀ, then their sums in partial order and dh,
// the adjoint gather through the transposed ELL array edge_nbr_rev, each
// entry scaled by its forward row's scale, minus the rev row.  No float
// atomics, so reruns are bit-identical, and every output has the bits of
// the earlier design of two launches forward and nine to eleven backward.
// The tiles are conv_grid.cuh's: cp.async rings, f32 FMA or bf16
// mma.sync (ldmatrix) with W (and dpre) rounded to bf16 once per call.
//
// Bound.  2·rows·Hin·H multiply-adds forward against (Hin + 2·H) elements
// per row (about three times the operations backward): at the model's
// widths (H = 400) bound by the products -- f32 FMA throughput outside the
// tensor cores, or the bf16 tensor-core rate -- not by memory.
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

#include "conv_grid.cuh"

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

// The backward's scratch: t and dt [rows, Hin] as Elem; dpre [rows, H],
// rscale [rows] and the dskip partials [kReduceBlocks] as f32; the
// product's partials and bf16 copies (conv_grid.cuh::ConvParts, S split-K
// partials).
template <bool kBf16>
struct Scratch {
  Elem<kBf16> *t, *dt;
  float *dpre, *rscale, *dpart;
  ConvParts<kBf16> parts;
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
  s.dpart = c.take<float>(kReduceBlocks);
  s.parts = carve_parts<kBf16>(c, S, rows, Hin, H);
  s.bytes = c.used;
  return s;
}

size_t scratch_bytes(int p, int te, int Hin, int H, int S, int mat) {
  return mat ? scratch_of<true>(nullptr, p, te, Hin, H, S).bytes
             : scratch_of<false>(nullptr, p, te, Hin, H, S).bytes;
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

// The layer (conv_grid.cuh::conv_layer): t = messages(h) into the
// scratch (t, then W rounded to bf16 at bf16), the output (of type O) to
// `out`.
template <bool kBf16, class O>
int layer(const ConvArgs<kBf16>& a, Elem<kBf16>* t, O* out, cudaStream_t st) {
  return conv_layer<kBf16, O>(a.graph(), a.h, a.Hin, a.w, a.b, a.skip, a.h0,
                              a.H, a.act, a.drop, 1, 0, t,
                              conv_fwd_w16<kBf16>(t, a.rows(), a.Hin), nullptr,
                              out, nullptr, st);
}

// The backward's arguments that K6 and K8/K9 share: t recomputed by `msg`
// (the pre-activation too for SiLU and GELU), dpre from g (and the saved
// output for ReLU), then the products, sums and dh's gather, each when
// its output is set.  The rows' scales of the adjoint are `scale` (K9) or
// the recomputed mean scales.
template <bool kBf16, class O>
ConvBwdArgs<kBf16, O, Elem<kBf16>> bwd_args(
    const ConvArgs<kBf16>& a, const GatherArgs<Elem<kBf16>, Elem<kBf16>>& msg,
    const int* edge_nbr_rev, const float* scale, const O* out, const O* g,
    Elem<kBf16>* dh, Elem<kBf16>* dh0, float* dw, float* db, float* dskip,
    const Scratch<kBf16>& s, int S, bool want_dt) {
  using E = Elem<kBf16>;
  const bool pre = needs_pre(a.act);
  ConvBwdArgs<kBf16, O, E> b{};
  b.recompute = 1;
  b.msg = msg;
  b.pre_epi = LayerEpi<E, E>{a.b,   a.h0,   a.skip,  a.act,   pre ? s.dpre : nullptr,
                             nullptr, a.H, nullptr, 1,       0, a.te};
  b.dpre_on = 1;
  b.g = g;
  b.out = a.act == kRelu ? out : nullptr;
  b.pre = pre ? s.dpre : nullptr;
  b.h0 = a.h0;
  b.dh0 = dh0;
  b.skip = a.skip;
  b.drop = a.drop;
  b.act = a.act;
  b.te = a.te;
  b.dpart = s.dpart;
  b.w = a.w;
  b.t = s.t;
  b.dpre = s.dpre;
  b.parts = s.parts;
  b.dt = want_dt ? s.dt : nullptr;
  b.dw = dw;
  b.db = db;
  b.dskip = dskip;
  b.dh = GatherArgs<E, E>{s.dt,  a.te, a.Hin, edge_nbr_rev, a.D, a.rev,
                          scale != nullptr ? scale
                                           : (a.mean ? s.rscale : nullptr),
                          0,     a.te, a.rows(), dh, nullptr};
  b.p = a.p;
  b.Hin = a.Hin;
  b.H = a.H;
  b.S = S;
  b.rows = a.rows();
  return b;
}

// out and g are O (the state type, or f32 with out_f32).
template <bool kBf16, class O>
int backward(const ConvArgs<kBf16>& a, const int* edge_nbr_rev, const O* out,
             const O* g, Elem<kBf16>* dh, Elem<kBf16>* dh0, float* dw,
             float* db, float* dskip, void* scratch, int S, cudaStream_t st) {
  using E = Elem<kBf16>;
  const Scratch<kBf16> s = scratch_of<kBf16>(scratch, a.p, a.te, a.Hin, a.H,
                                             S);
  const GatherArgs<E, E> msg{a.h, a.te, a.Hin, a.edge_nbr, a.D, a.rev,
                             nullptr, a.mean, a.te, a.rows(), s.t,
                             a.mean ? s.rscale : nullptr};
  return launch_conv_bwd(bwd_args<kBf16, O>(a, msg, edge_nbr_rev, nullptr,
                                            out, g, dh, dh0, dw, db, dskip, s,
                                            S, dh != nullptr),
                         st);
}

// The edge-partitioned layer's message gather: t = messages(h) plus the
// boundary term of r, each row's scale to rscale (when set).
template <bool kBf16>
GatherArgs<Elem<kBf16>, Elem<kBf16>> messages_r(
    const ConvArgs<kBf16>& a, const float* r, const int* senders,
    const float* scale, Elem<kBf16>* t, float* rscale, int tn) {
  return GatherArgs<Elem<kBf16>, Elem<kBf16>>{
      a.h,  a.te,     a.Hin, a.edge_nbr, a.D,  a.rev,    nullptr, a.mean,
      a.te, a.rows(), t,     rscale,     scale, r, senders, tn};
}

template <bool kBf16>
int r_forward(const ConvArgs<kBf16>& a, const float* r, const int* senders,
              const float* scale, void* t_, void* out_, int tn,
              cudaStream_t st) {
  using E = Elem<kBf16>;
  E* t = static_cast<E*>(t_);
  ConvFwdArgs<kBf16, E> f{};
  f.msg = messages_r<kBf16>(a, r, senders, scale, t, nullptr, tn);
  f.w = a.w;
  f.w16 = conv_fwd_w16<kBf16>(t, a.rows(), a.Hin);
  f.epi = LayerEpi<E>{a.b,  a.h0, a.skip, a.act, nullptr, static_cast<E*>(out_),
                      a.H, a.drop, 1,     0,     a.te};
  f.p = a.p;
  f.Hin = a.Hin;
  f.H = a.H;
  return launch_conv_fwd(f, st);
}

template <bool kBf16>
int r_backward(const ConvArgs<kBf16>& a, const float* r, const int* senders,
               const float* scale, const int* edge_nbr_rev,
               const int* node_out, const void* out_, const void* g_,
               void* dh_, float* dr, void* dh0_, float* dw, float* db,
               float* dskip, void* scratch, int tn, int Dout, int S,
               cudaStream_t st) {
  using E = Elem<kBf16>;
  const Scratch<kBf16> s = scratch_of<kBf16>(scratch, a.p, a.te, a.Hin, a.H,
                                             S);
  E* dh = static_cast<E*>(dh_);
  ConvBwdArgs<kBf16, E, E> b = bwd_args<kBf16, E>(
      a, messages_r<kBf16>(a, r, senders, scale, s.t, s.rscale, tn),
      edge_nbr_rev, scale, static_cast<const E*>(out_),
      static_cast<const E*>(g_), dh, static_cast<E*>(dh0_), dw, db, dskip, s,
      S, dh != nullptr || dr != nullptr);
  // dr[n] = Σ over the out-edges e of node n of s_e·dt[e] (f32)
  b.dr = GatherArgs<E, float>{s.dt, a.te, a.Hin, node_out, Dout, nullptr,
                              scale, 0, tn, static_cast<long long>(a.p) * tn,
                              dr, nullptr};
  return launch_conv_bwd(b, st);
}

}  // namespace

namespace {

// A launch's own error code, or the runtime's last one.
int status(int err) {
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace

// The cooperative grid of a launch over p·te rows at widths Hin and H
// (backward: the widest of the two), at mat 0 (f32) or 1 (bf16), on the
// current device: returns the blocks (or minus a CUDA error code) and
// writes the tile rows, the blocks per SM and the SMs.
extern "C" int cgr_fused_conv_grid(int p, int te, int Hin, int H, int mat,
                                   int backward, int* bm, int* per_sm,
                                   int* sms) {
  using B = Elem<true>;
  const long long rows = static_cast<long long>(p) * te;
  const void *fn32 = nullptr, *fn64 = nullptr, *fn = nullptr;
  if (backward) {
    fn32 = mat ? reinterpret_cast<const void*>(&conv_bwd_kernel<true, 32, B, B>)
               : reinterpret_cast<const void*>(
                     &conv_bwd_kernel<false, 32, float, float>);
    fn64 = mat ? reinterpret_cast<const void*>(&conv_bwd_kernel<true, 64, B, B>)
               : reinterpret_cast<const void*>(
                     &conv_bwd_kernel<false, 64, float, float>);
  } else {
    fn32 = mat ? reinterpret_cast<const void*>(&conv_fwd_kernel<true, 32, B>)
               : reinterpret_cast<const void*>(&conv_fwd_kernel<false, 32, float>);
    fn64 = mat ? reinterpret_cast<const void*>(&conv_fwd_kernel<true, 64, B>)
               : reinterpret_cast<const void*>(&conv_fwd_kernel<false, 64, float>);
  }
  int grid = 0;
  const int err = conv_grid_of(fn32, fn64, rows, backward && Hin > H ? Hin : H,
                               &fn, bm, &grid, per_sm, sms);
  return err != 0 ? -err : grid;
}

// out [p·te, H]; t is scratch of ops/fused_conv.py::fwd_scratch_elems
// elements (t, then at bf16 W rounded to bf16); h, h0 and t of one type (f32, or bf16 with mat = 1), out of that type too
// unless out_f32.  One cooperative launch.
extern "C" int cgr_fused_conv_fwd(const void* h, const void* h0,
                                  const int* edge_nbr, const int* rev,
                                  const float* w, const float* b,
                                  const float* skip, const int* drop,
                                  void* t, void* out, int p, int te,
                                  int Hin, int H, int D, int act, int mean,
                                  int mat, int out_f32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using B = Elem<true>;
  if (!mat)
    return status(layer<false, float>(
        args_of<false>(h, h0, edge_nbr, rev, w, b, skip, drop, p, te, Hin, H,
                       D, act, mean),
        static_cast<float*>(t), static_cast<float*>(out), st));
  const ConvArgs<true> a = args_of<true>(h, h0, edge_nbr, rev, w, b, skip,
                                         drop, p, te, Hin, H, D, act, mean);
  return status(out_f32 ? layer<true, float>(a, static_cast<B*>(t),
                                             static_cast<float*>(out), st)
                        : layer<true, B>(a, static_cast<B*>(t),
                                         static_cast<B*>(out), st));
}

// Bytes of the backward's scratch (K6's, and K8/K9's).
extern "C" long long cgr_fused_conv_bwd_scratch_bytes(int p, int te, int Hin,
                                                      int H, int S, int mat) {
  return static_cast<long long>(scratch_bytes(p, te, Hin, H, S, mat));
}

// dh [rows, Hin], dh0 [rows, H] (h's type), dw [Hin, H], db [H], dskip [1]
// from the cotangent g of the forward's output `out` (both of out's type);
// a null output is skipped.  One cooperative launch.
extern "C" int cgr_fused_conv_bwd(
    const void* h, const void* h0, const int* edge_nbr, const int* rev,
    const int* edge_nbr_rev, const float* w, const float* b,
    const float* skip, const int* drop, const void* out, const void* g,
    void* dh, void* dh0, float* dw, float* db, float* dskip, void* scratch,
    int p, int te, int Hin, int H, int D, int act, int mean, int S, int mat,
    int out_f32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using B = Elem<true>;
  if (!mat)
    return status(backward<false, float>(
        args_of<false>(h, h0, edge_nbr, rev, w, b, skip, drop, p, te, Hin, H,
                       D, act, mean),
        edge_nbr_rev, static_cast<const float*>(out),
        static_cast<const float*>(g), static_cast<float*>(dh),
        static_cast<float*>(dh0), dw, db, dskip, scratch, S, st));
  const ConvArgs<true> a = args_of<true>(h, h0, edge_nbr, rev, w, b, skip,
                                         drop, p, te, Hin, H, D, act, mean);
  if (out_f32)
    return status(backward<true, float>(
        a, edge_nbr_rev, static_cast<const float*>(out),
        static_cast<const float*>(g), static_cast<B*>(dh),
        static_cast<B*>(dh0), dw, db, dskip, scratch, S, st));
  return status(backward<true, B>(
      a, edge_nbr_rev, static_cast<const B*>(out), static_cast<const B*>(g),
      static_cast<B*>(dh), static_cast<B*>(dh0), dw, db, dskip, scratch, S,
      st));
}

// out [p·te, H]; t is scratch of ops/fused_conv.py::fwd_scratch_elems
// elements; scale [p·te] (K9) or null (K8).  h, h0, t and out are f32, or bf16 with
// mat = 1; r is f32.  One cooperative launch.
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
  if (mat)
    return status(r_forward<true>(
        args_of<true>(h, h0, edge_nbr, rev, w, b, skip, drop, p, te, Hin, H,
                      D, act, mean),
        r, senders, scale, t, out, tn, st));
  return status(r_forward<false>(
      args_of<false>(h, h0, edge_nbr, rev, w, b, skip, drop, p, te, Hin, H, D,
                     act, mean),
      r, senders, scale, t, out, tn, st));
}

// dh [p·te, Hin], dr [p·tn, Hin] (f32), dh0 [p·te, H], dw [Hin, H], db [H],
// dskip [1] from the cotangent g of `out`; a null output is skipped.  h,
// h0, out, g, dh and dh0 are f32, or bf16 with mat = 1.  One cooperative
// launch.
extern "C" int cgr_fused_conv_r_bwd(
    const void* h, const float* r, const void* h0, const int* edge_nbr,
    const int* rev, const int* senders, const float* scale,
    const int* edge_nbr_rev, const int* node_out, const float* w,
    const float* b, const float* skip, const int* drop, const void* out,
    const void* g, void* dh, float* dr, void* dh0, float* dw, float* db,
    float* dskip, void* scratch, int p, int te, int tn, int Hin, int H, int D,
    int Dout, int act, int mean, int S, int mat, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mat)
    return status(r_backward<true>(
        args_of<true>(h, h0, edge_nbr, rev, w, b, skip, drop, p, te, Hin, H,
                      D, act, mean),
        r, senders, scale, edge_nbr_rev, node_out, out, g, dh, dr, dh0, dw,
        db, dskip, scratch, tn, Dout, S, st));
  return status(r_backward<false>(
      args_of<false>(h, h0, edge_nbr, rev, w, b, skip, drop, p, te, Hin, H, D,
                     act, mean),
      r, senders, scale, edge_nbr_rev, node_out, out, g, dh, dr, dh0, dw, db,
      dskip, scratch, tn, Dout, S, st));
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
