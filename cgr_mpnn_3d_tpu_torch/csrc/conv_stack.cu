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
// mat = 1 is the TPU kernels' mat_dtype = out_dtype = bf16: h0, the output,
// the cotangent g and dh0 are bf16, every layer's state and messages are
// held in bf16 (pallas_stack.py rounds them at every use as an operand, so
// the numbers are the same), the products run on the tensor cores, and the
// mean scale is bf16(1 / degree); pre-activations, dpre, the dh0 sum and
// the weight gradients stay f32 (layered_common.cuh).
//
// Design.  On the TPU one grid step keeps a pack's edge state in VMEM for
// all L layers.  A te x H f32 state (400 KB at te = 256, H = 400) does not
// fit a block's 227 KB of shared memory, and messages gather rows from all
// over the pack, so here every layer is two grid-wide launches over the
// whole batch: one cooperative launch (conv_grid.cuh::conv_layer) of the
// message gather into a scratch t, a grid barrier, then the product
// t·W[l] as output tiles with bias, skip, activation and dropout in their
// epilogue (LayerEpi, which takes the pack of a row from the row index,
// never from blockIdx).  The launch boundary is the barrier that the
// layer dependency needs, and every SM works at any p.  The layer and its
// backward steps are conv_grid.cuh's conv_layer and conv_layer_bwd and
// layered_common.cuh's dpre_kernel, which fused_conv.cu (K6, one layer)
// runs too (its dpre as a phase of its one launch).
//
// Backward (pallas_stack.py:96-157): the replay keeps every layer's t and
// pre-activation in scratch (L·p·te·H of each, 1.4 GB in f32 at 436 packs
// of full width), then walks the layers in reverse:
//   dpre_l = drop_l'(g)·act'(pre_l),  dh0 += skip[l]·dpre_l (f32),
//   dskip[l] = Σ dpre_l·h0 (per-block partials, summed in block order),
//   dW[l] = t_lᵀ·dpre_l, db[l] = Σ_r dpre_l (split-K partials, summed in
//   split order), g = adjoint of the messages applied to dpre_l·W[l]ᵀ,
// the adjoint being a gather through edge_nbr_rev (each entry scaled by its
// forward row's scale for mean) minus the rev row, as in
// fused_model_bwd.cu; the stack's input cotangent is dh0 + g, stored once.
// No float atomics: reruns are bit-identical.
//
// Bound.  Per layer 2·rows·H² multiply-adds forward (about three times
// that backward, plus the replay) against 3·H·4 bytes per row (half of it
// in bf16): bound by the products -- f32 FMA throughput outside the tensor
// cores, or the bf16 tensor-core rate -- not by memory.

#include "conv_grid.cuh"

namespace {

using namespace cgr;

template <bool kBf16>
struct StackArgs {
  const Elem<kBf16>* h0;
  const int *edge_nbr, *rev;
  const float *w, *b, *skips;
  const int* drop;  // [3, L] dropout table, or nullptr in eval mode
  int p, te, H, L, D, act, mean;
  long long rows() const { return static_cast<long long>(p) * te; }
  ConvGraph graph() const {
    return ConvGraph{edge_nbr, rev, D, mean, te, rows()};
  }
};

// Layer l of the forward (conv_grid.cuh::conv_layer): h_out =
// layer(messages(h_in)); the pre-activation goes to `pre` when it is set;
// w16 is scratch for W[l] rounded to bf16 (null at f32).  Returns 0 or a
// CUDA error code.
template <bool kBf16>
int layer(const StackArgs<kBf16>& a, int l, const Elem<kBf16>* h_in,
          Elem<kBf16>* t, Elem<kBf16>* w16, float* pre, Elem<kBf16>* h_out,
          float* rscale, cudaStream_t st) {
  const size_t HH = static_cast<size_t>(a.H) * a.H;
  return conv_layer<kBf16>(a.graph(), h_in, a.H, a.w + l * HH,
                           a.b + static_cast<size_t>(l) * a.H, a.skips + l,
                           a.h0, a.H, a.act, a.drop, a.L, l, t, w16, pre,
                           h_out, rscale, st);
}

// The first error of a sequence of launches.
inline int first(int err, int next) { return err != 0 ? err : next; }

// out = acc + g over n elements, stored as E (out may be acc).
template <class E>
__global__ void finish_kernel(E* out, const float* acc, const float* g,
                              long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = from_f32<E>(acc[i] + g[i]);
}

// The backward's scratch: ts [L, rows, H] and h, dt [rows, H] as Elem;
// pres [L, rows, H], g [rows, H], the dh0 sum [rows, H] (bf16 only: f32
// sums into dh0 itself), escale [rows] and the dskip partials
// [kReduceBlocks, L] as f32; a layer's product partials and bf16 copies
// (conv_grid.cuh::ConvParts).
template <bool kBf16>
struct Scratch {
  Elem<kBf16> *ts, *h, *dt;
  float *pres, *g, *dacc, *escale, *dpart;
  ConvParts<kBf16> parts;
  size_t bytes;
};

template <bool kBf16>
Scratch<kBf16> scratch_of(void* base, int p, int te, int H, int L, int S) {
  using E = Elem<kBf16>;
  const long long rows = static_cast<long long>(p) * te, rH = rows * H;
  Carve c{static_cast<char*>(base)};
  Scratch<kBf16> s;
  s.ts = c.take<E>(L * rH);
  s.h = c.take<E>(rH);
  s.dt = c.take<E>(rH);
  s.pres = c.take<float>(L * rH);
  s.g = c.take<float>(rH);
  s.dacc = kBf16 ? c.take<float>(rH) : nullptr;
  s.escale = c.take<float>(rows);
  s.dpart = c.take<float>(static_cast<long long>(kReduceBlocks) * L);
  s.parts = carve_parts<kBf16>(c, S, rows, H, H);
  s.bytes = c.used;
  return s;
}

// t: ops/fused_conv.py::fwd_scratch_elems(rows, H, H) elements.
template <bool kBf16>
int forward(const StackArgs<kBf16>& a, Elem<kBf16>* t, Elem<kBf16>* out,
            cudaStream_t st) {
  Elem<kBf16>* w16 = conv_fwd_w16<kBf16>(t, a.rows(), a.H);
  int err = 0;
  for (int l = 0; l < a.L; ++l)
    err = first(err, layer(a, l, l == 0 ? a.h0 : out, t, w16, nullptr, out,
                           nullptr, st));
  return err;
}

template <bool kBf16>
int backward(const StackArgs<kBf16>& a, const int* edge_nbr_rev,
              const Elem<kBf16>* g_out, Elem<kBf16>* dh0, float* dw,
              float* db, float* dskip, void* scratch, int S,
              cudaStream_t st) {
  using E = Elem<kBf16>;
  const int H = a.H, L = a.L;
  const long long rH = a.rows() * H;
  const size_t HH = static_cast<size_t>(H) * H;
  const Scratch<kBf16> s = scratch_of<kBf16>(scratch, a.p, a.te, H, L, S);
  float* dacc = kBf16 ? s.dacc : reinterpret_cast<float*>(dh0);

  // replay, keeping every layer's messages and pre-activations
  int err = 0;
  for (int l = 0; l < L; ++l)
    err = first(err, layer(a, l, l == 0 ? a.h0 : s.h, s.ts + l * rH,
                           s.parts.w16, s.pres + l * rH, s.h,
                           l == 0 ? s.escale : nullptr, st));

  const ConvGraph gr = a.graph();
  for (int l = L - 1; l >= 0; --l) {
    float* dpre = s.pres + l * rH;
    if (l == L - 1)
      dpre_kernel<E, E, float><<<kReduceBlocks, kThreads, 0, st>>>(
          g_out, dpre, nullptr, dpre, a.h0, dacc, 0, a.skips + l, a.drop, L,
          l, a.act, a.te, H, rH, s.dpart);
    else
      dpre_kernel<float, E, float><<<kReduceBlocks, kThreads, 0, st>>>(
          s.g, dpre, nullptr, dpre, a.h0, dacc, 1, a.skips + l, a.drop, L, l,
          a.act, a.te, H, rH, s.dpart);
    // dW[l], db[l], and g = the messages' adjoint applied to dpre·W[l]ᵀ
    err = first(err, conv_layer_bwd<kBf16>(
                         gr, edge_nbr_rev, s.ts + l * rH, H, dpre, H,
                         a.w + l * HH, s.escale, S, s.parts, s.dt, s.g,
                         dw + l * HH, db + static_cast<size_t>(l) * H, st));
  }
  finish_kernel<E><<<2048, 256, 0, st>>>(dh0, dacc, s.g, rH);
  launch_sum(s.dpart, kReduceBlocks, L, dskip, st);
  return err;
}

}  // namespace

// out [p·te, H] (the last layer's state); t is scratch of
// ops/fused_conv.py::fwd_scratch_elems(p·te, H, H, mat) elements; both of
// h0's type (f32, or bf16 with mat = 1).  One cooperative launch a layer.
extern "C" int cgr_conv_stack_fwd(const void* h0, const int* edge_nbr,
                                  const int* rev, const float* w,
                                  const float* b, const float* skips,
                                  const int* drop, void* t, void* out, int p,
                                  int te, int H, int L, int D, int act,
                                  int mean, int mat, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (mat) {
    using E = Elem<true>;
    err = forward(StackArgs<true>{static_cast<const E*>(h0), edge_nbr, rev,
                                  w, b, skips, drop, p, te, H, L, D, act,
                                  mean},
                  static_cast<E*>(t), static_cast<E*>(out), st);
  } else {
    err = forward(StackArgs<false>{static_cast<const float*>(h0), edge_nbr,
                                   rev, w, b, skips, drop, p, te, H, L, D,
                                   act, mean},
                  static_cast<float*>(t), static_cast<float*>(out), st);
  }
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

// Bytes of the backward's scratch.
extern "C" long long cgr_conv_stack_bwd_scratch_bytes(int p, int te, int H,
                                                      int L, int S, int mat) {
  return static_cast<long long>(
      mat ? scratch_of<true>(nullptr, p, te, H, L, S).bytes
          : scratch_of<false>(nullptr, p, te, H, L, S).bytes);
}

// dh0 [rows, H] (h0's type), dw [L, H, H], db [L, H], dskip [L] from the
// cotangent g of the forward's output (h0's type).
extern "C" int cgr_conv_stack_bwd(const void* h0, const int* edge_nbr,
                                  const int* rev, const int* edge_nbr_rev,
                                  const float* w, const float* b,
                                  const float* skips, const int* drop,
                                  const void* g_out, void* dh0, float* dw,
                                  float* db, float* dskip, void* scratch,
                                  int p, int te, int H, int L, int D, int act,
                                  int mean, int S, int mat, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (mat) {
    using E = Elem<true>;
    err = backward(StackArgs<true>{static_cast<const E*>(h0), edge_nbr, rev,
                                   w, b, skips, drop, p, te, H, L, D, act,
                                   mean},
                   edge_nbr_rev, static_cast<const E*>(g_out),
                   static_cast<E*>(dh0), dw, db, dskip, scratch, S, st);
  } else {
    err = backward(StackArgs<false>{static_cast<const float*>(h0), edge_nbr,
                                    rev, w, b, skips, drop, p, te, H, L, D,
                                    act, mean},
                   edge_nbr_rev, static_cast<const float*>(g_out),
                   static_cast<float*>(dh0), dw, db, dskip, scratch, S, st);
  }
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
