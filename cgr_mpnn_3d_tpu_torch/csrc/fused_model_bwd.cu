// Whole-model CGR-MPNN backward, one thread block per pack (CUDA C++,
// sm_90a): the training step's compute (K2) and the VJP of the forward
// (K3b) in one __global__, as on the TPU.
//
// Replaces cgr_mpnn_3d_tpu/ops/pallas_model.py::_bwd_kernel, launched there
// by fused_model_train (with_loss: labels and mask in, dpred = 2·mask·(pred
// − y) and the masked SSE derived in-kernel) and by _bwd_call (the custom
// VJP of fused_model: dpred in).  Per pack the block replays the forward of
// fused_model_common.cuh::forward_pack (train-mode hash dropout included),
// then walks it backwards and writes the pack's share of the 11 parameter
// gradients (and of the SSE) to its own slice of a partial buffer.  A
// second launch sums the slices over packs in pack order.  No atomics, so
// reruns and resumed runs are bit-identical.  The graph inputs need no
// gradients, so none leaves the kernel.
//
// Design.
// * State: the replay keeps pre0, h0, every layer's message t and
//   pre-activation, s, pre_n, hn and pooled in per-pack device-memory
//   scratch that the wrapper allocates ((2L + 5)·te·H + (3·tn + tb)·H
//   floats, ≈ 6 MB per pack at full width); the backward overwrites them in
//   place with the cotangents once they are no longer needed.
// * Adjoint gathers without atomics: each gather of the forward is
//   transposed into a gather through the index arrays the packer already
//   carries -- messages through edge_nbr_rev (each contribution scaled by
//   the forward row's 1/degree for mean, computed once per pack) minus the
//   rev row, the incoming sum through receivers, pooling through
//   graph_of_node.  x[senders] needs no adjoint: dWx takes the gathered x
//   rows as its transposed operand.  Indices outside the pack count as
//   absent in both directions.
// * Products: the tiled product of the forward, with a transposed A
//   operand for the weight-gradient products (Aᵀ·B over the pack's rows)
//   and a transposed B for the cotangents through the weights (dpre·Wᵀ).
// * bf16 (mat_dtype 1, the TPU kernel at mat_dtype=bf16): the replay is the
//   forward's bf16 instantiation, and every backward product, gather and
//   head term rounds its operands to bf16 as _bwd_kernel does -- dpred in
//   the head products, dpooled, dpre_n and ds, each layer's dpre and dt,
//   dpre0 -- with the bf16 mean scales; the products run on the tensor
//   cores (f32 sums).  The loss, dpred, the ReLU mask, the bias and skip
//   gradients and dh0 stay f32, as do the per-pack partials and their sum.
// * dskips[l] = Σ dpre_l·h0 is a block reduction in a fixed order.
//
// Bound.  Per pack the replay needs the forward's f32 FMAs (≈ 0.43 GFLOP at
// full width, x part of edge_init once per node) and the backward about two
// more products of the same size per dense layer (the cotangent through the
// weights and the weight gradient), ≈ 1.2 GFLOP per pack in all, against a
// few hundred KB of input and ≈ 4.1 MB of partial gradients per pack: bound
// by f32 FMA throughput outside the tensor cores.  Like the forward, the
// kernel multiplies the gathered x rows once per edge, and one block per
// pack leaves most SMs idle at small batches (wgmma, TMA and several
// blocks per pack are later work).  In bf16 the products are tensor-core
// work (bound 15x lower than f32's), and the staging loops, the gathers and
// the elementwise passes over the pack's states set the time.

#include "fused_model_common.cuh"

namespace {

using namespace cgr;

// Offsets (floats) of the gradients in one pack's partial slice; the
// wrapper splits the summed buffer in the same order.
struct GradLayout {
  size_t sse, dwx, dwe, dbe, dwc, dbc, dskips, dws, dwxn, dben, dwffn, dbffn,
      total;
  __host__ __device__ GradLayout(int F, int Fe, int H, int L) {
    size_t o = 0;
    sse = o;    o += 1;
    dwx = o;    o += static_cast<size_t>(F) * H;
    dwe = o;    o += static_cast<size_t>(Fe) * H;
    dbe = o;    o += H;
    dwc = o;    o += static_cast<size_t>(L) * H * H;
    dbc = o;    o += static_cast<size_t>(L) * H;
    dskips = o; o += L;
    dws = o;    o += static_cast<size_t>(H) * H;
    dwxn = o;   o += static_cast<size_t>(F) * H;
    dben = o;   o += H;
    dwffn = o;  o += H;
    dbffn = o;  o += 1;
    total = o;
  }
};

// Offsets (floats) of one pack's scratch.
struct ScratchLayout {
  size_t pre0, h0, t, pre, h, g, dh0, s, pre_n, hn, pooled, preds, dpred,
      escale, nscale, gscale, total;
  __host__ __device__ ScratchLayout(int te, int tn, int tb, int H, int L) {
    const size_t teH = static_cast<size_t>(te) * H,
                 tnH = static_cast<size_t>(tn) * H;
    size_t o = 0;
    pre0 = o;   o += teH;
    h0 = o;     o += teH;
    t = o;      o += L * teH;
    pre = o;    o += L * teH;
    h = o;      o += teH;
    g = o;      o += teH;
    dh0 = o;    o += teH;
    s = o;      o += tnH;
    pre_n = o;  o += tnH;
    hn = o;     o += tnH;
    pooled = o; o += static_cast<size_t>(tb) * H;
    preds = o;  o += tb;
    dpred = o;  o += tb;
    escale = o; o += te;
    nscale = o; o += tn;
    gscale = o; o += tb;
    total = o;
  }
};

struct BwdArgs {
  const int *receivers, *edge_nbr_rev, *graph_of_node;
  const float *labels, *mask;  // with the loss (K2), else nullptr
  const float* dpred;          // without the loss (K3b), else nullptr
  float *scratch, *partial;
};

// out[r] = mean_colscale(entries of ids[r, :] inside [lo, lo + n)) when
// `mean`, else 1: the forward's scale of row r.
template <bool kBf16>
__device__ void row_scales(const int* __restrict__ ids, int D, int lo, int n,
                           int R, bool mean, float* __restrict__ out) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    int count = 0;
    for (int d = 0; d < D; ++d) {
      const int j = ids[static_cast<size_t>(r) * D + d] - lo;
      count += (j >= 0 && j < n);
    }
    out[r] = mean ? mean_colscale<kBf16>(count) : 1.f;
  }
}

// out[c] = Σ_r a[r, c] over R rows of width H, rows in order.
__device__ void col_sum(const float* __restrict__ a, int R, int H,
                        float* __restrict__ out) {
  for (int c = threadIdx.x; c < H; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += a[static_cast<size_t>(r) * H + c];
    out[c] = s;
  }
}

// The sum of v over the block, in a fixed order; synchronises the block.
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    fused_model_bwd_kernel(const ModelArgs a, const BwdArgs b) {
  __shared__ SmemOf<kBf16> sm;
  __shared__ float red[kThreads];
  const int H = a.H, te = a.te, tn = a.tn, tb = a.tb, F = a.F, tid = threadIdx.x;
  const int eb = blockIdx.x * te, nb = blockIdx.x * tn, gb = blockIdx.x * tb;
  const size_t teH = static_cast<size_t>(te) * H;
  const ScratchLayout sl(te, tn, tb, H, a.L);
  const GradLayout gl(F, a.Fe, H, a.L);
  float* base = b.scratch + blockIdx.x * sl.total;
  float* part = b.partial + blockIdx.x * gl.total;
  float *pre0 = base + sl.pre0, *h0 = base + sl.h0, *t = base + sl.t,
        *pre = base + sl.pre, *g = base + sl.g, *dh0 = base + sl.dh0,
        *s = base + sl.s, *pre_n = base + sl.pre_n, *pooled = base + sl.pooled,
        *preds = base + sl.preds, *dpred = base + sl.dpred,
        *escale = base + sl.escale, *nscale = base + sl.nscale,
        *gscale = base + sl.gscale;
  const float* x = a.x + static_cast<size_t>(nb) * F;
  const float* e = a.e + static_cast<size_t>(eb) * a.Fe;

  // the forward's mean scales, and the replay
  row_scales<kBf16>(a.edge_nbr + static_cast<size_t>(eb) * a.D, a.D, eb, te,
                    te, a.mean_aggr != 0, escale);
  row_scales<kBf16>(a.node_inc + static_cast<size_t>(nb) * a.D, a.D, eb, te,
                    tn, a.mean_aggr != 0, nscale);
  row_scales<kBf16>(a.graph_nodes + static_cast<size_t>(gb) * a.DN, a.DN, nb,
                    tn, tb, a.mean_pool != 0, gscale);
  for (size_t i = tid; i < teH; i += kThreads) dh0[i] = 0.f;
  forward_pack<kBf16>(a,
                      FwdState{pre0, h0, t, pre, base + sl.h, s, pre_n,
                               base + sl.hn, pooled, preds, teH, teH},
                      sm);

  // loss and cotangent of the predictions
  if (tid == 0) {
    float sse = 0.f;
    for (int q = 0; q < tb; ++q) {
      float d;
      if (b.labels != nullptr) {
        const float err = (preds[q] - b.labels[gb + q]) * b.mask[gb + q];
        sse += err * err;
        d = 2.f * err;
      } else {
        d = b.dpred[gb + q];
      }
      dpred[q] = d;
    }
    part[gl.sse] = sse;
  }
  __syncthreads();

  // ffn head
  for (int c = tid; c < H; c += kThreads) {
    float v = 0.f;
    for (int q = 0; q < tb; ++q)
      v = fmaf(operand<kBf16>(pooled[static_cast<size_t>(q) * H + c]),
               operand<kBf16>(dpred[q]), v);
    part[gl.dwffn + c] = v;
  }
  if (tid == 0) {
    float v = 0.f;
    for (int q = 0; q < tb; ++q) v += dpred[q];
    part[gl.dbffn] = v;
  }
  // pooling adjoint and the readout's activation: dpre_n over pre_n
  // (dpooled = dpred·wffnᵀ, an operand of the pooling adjoint)
  for (int i = tid; i < tn * H; i += kThreads) {
    const int n = i / H, c = i % H;
    const int q = b.graph_of_node[nb + n] - gb;
    const float dhn =
        (q >= 0 && q < tb)
            ? gscale[q] * operand<kBf16>(operand<kBf16>(dpred[q]) *
                                         operand<kBf16>(a.wffn[c]))
            : 0.f;
    pre_n[i] = dhn * k_dact(a.act, pre_n[i]);
  }
  __syncthreads();

  // readout weights; then ds = dpre_n·Wsᵀ over s
  gemm<kBf16, true, false>(Operands{Rows{s, H, nullptr, 0, 0}, pre_n, H, tn},
                           nullptr, H, H, StoreEpi{part + gl.dws, H}, sm);
  gemm<kBf16, true, false>(Operands{Rows{x, F, nullptr, 0, 0}, pre_n, H, tn},
                           nullptr, F, H, StoreEpi{part + gl.dwxn, H}, sm);
  col_sum(pre_n, tn, H, part + gl.dben);
  __syncthreads();
  gemm<kBf16, false, true>(
      Operands{Rows{pre_n, H, nullptr, 0, 0}, a.ws, H, H}, nullptr, tn, H,
      StoreEpi{s, H}, sm);
  __syncthreads();

  // incoming-sum adjoint: g[e] = scale_r·ds[r], r = receivers[e]
  for (size_t i = tid; i < teH; i += kThreads) {
    const int r = static_cast<int>(i / H), c = static_cast<int>(i % H);
    const int n = b.receivers[eb + r] - nb;
    g[i] = (n >= 0 && n < tn)
               ? nscale[n] * operand<kBf16>(s[static_cast<size_t>(n) * H + c])
               : 0.f;
  }
  __syncthreads();

  // conv stack, in reverse
  for (int l = a.L - 1; l >= 0; --l) {
    float* t_l = t + l * teH;
    float* dpre = pre + l * teH;          // pre_l, overwritten by dpre_l
    const Dropout drop = layer_dropout(a.drop, a.L, l);
    const float skip = a.skips[l];
    float dsk = 0.f;
    for (size_t i = tid; i < teH; i += kThreads) {
      const int r = static_cast<int>(i / H), c = static_cast<int>(i % H);
      float gg = g[i];
      if (drop.on) gg = drop.kept(r, c) ? gg * drop.scale : 0.f;
      const float v = gg * k_dact(a.act, dpre[i]);
      dpre[i] = v;
      dsk = fmaf(v, h0[i], dsk);
      dh0[i] = fmaf(skip, v, dh0[i]);
    }
    const float dskip = block_sum(dsk, red);
    if (tid == 0) part[gl.dskips + l] = dskip;
    gemm<kBf16, true, false>(
        Operands{Rows{t_l, H, nullptr, 0, 0}, dpre, H, te}, nullptr, H, H,
        StoreEpi{part + gl.dwc + static_cast<size_t>(l) * H * H, H}, sm);
    col_sum(dpre, te, H, part + gl.dbc + static_cast<size_t>(l) * H);
    __syncthreads();
    // dt = dpre_l·Wc[l]ᵀ over t_l
    gemm<kBf16, false, true>(
        Operands{Rows{dpre, H, nullptr, 0, 0},
                 a.wc + static_cast<size_t>(l) * H * H, H, H},
        nullptr, te, H, StoreEpi{t_l, H}, sm);
    __syncthreads();
    // message adjoint: g[c] = Σ_{e in edge_nbr_rev[c]} scale_e·dt[e] − dt[rev[c]]
    for (size_t i = tid; i < teH; i += kThreads) {
      const int r = static_cast<int>(i / H), c = static_cast<int>(i % H);
      const int* nbr = b.edge_nbr_rev + static_cast<size_t>(eb + r) * a.D;
      float sum = 0.f;
      for (int d = 0; d < a.D; ++d) {
        const int j = nbr[d] - eb;
        if (j >= 0 && j < te)
          sum += escale[j] *
                 operand<kBf16>(t_l[static_cast<size_t>(j) * H + c]);
      }
      const int j = a.rev[eb + r] - eb;
      if (j >= 0 && j < te)
        sum -= operand<kBf16>(t_l[static_cast<size_t>(j) * H + c]);
      g[i] = sum;
    }
    __syncthreads();
  }

  // edge_init
  for (size_t i = tid; i < teH; i += kThreads)
    pre0[i] = (dh0[i] + g[i]) * k_dact(a.act, pre0[i]);
  __syncthreads();
  gemm<kBf16, true, false>(
      Operands{Rows{x, F, a.senders + eb, nb, tn}, pre0, H, te}, nullptr, F,
      H, StoreEpi{part + gl.dwx, H}, sm);
  gemm<kBf16, true, false>(Operands{Rows{e, a.Fe, nullptr, 0, 0}, pre0, H, te},
                           nullptr, a.Fe, H, StoreEpi{part + gl.dwe, H}, sm);
  col_sum(pre0, te, H, part + gl.dbe);
}

// out[i] = Σ_q part[q, i] over the p packs, in pack order.
__global__ void sum_packs_kernel(const float* __restrict__ part, int p,
                                 long long G, float* __restrict__ out) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < G; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < p; ++q) s += part[static_cast<size_t>(q) * G + i];
    out[i] = s;
  }
}

int launch(const ModelArgs& a, const BwdArgs& b, float* out, int p,
           int mat_dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mat_dtype == 1)
    fused_model_bwd_kernel<true><<<p, kThreads, 0, st>>>(a, b);
  else
    fused_model_bwd_kernel<false><<<p, kThreads, 0, st>>>(a, b);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long G = static_cast<long long>(GradLayout(a.F, a.Fe, a.H, a.L).total);
  const long long blocks = (G + 255) / 256 < 2048 ? (G + 255) / 256 : 2048;
  sum_packs_kernel<<<static_cast<int>(blocks), 256, 0, st>>>(b.partial, p, G,
                                                             out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch floats per pack, and the floats of one gradient buffer ([sse,
// dwx, dwe, dbe, dwc, dbc, dskips, dws, dwxn, dben, dwffn, dbffn]).
extern "C" long long cgr_fused_model_bwd_scratch_floats(int te, int tn, int tb,
                                                       int H, int L) {
  return static_cast<long long>(ScratchLayout(te, tn, tb, H, L).total);
}

extern "C" long long cgr_fused_model_grad_floats(int F, int Fe, int H, int L) {
  return static_cast<long long>(GradLayout(F, Fe, H, L).total);
}

#define CGR_MODEL_PARAMS                                                     \
  const float *x, const float *e, const int *senders, const int *edge_nbr,   \
      const int *rev, const int *node_inc, const int *graph_nodes,           \
      const float *wx, const float *we, const float *be, const float *wc,    \
      const float *bc, const float *skips, const float *ws, const float *wxn, \
      const float *ben, const float *wffn, const float *bffn, const int *drop, \
      const int *receivers, const int *edge_nbr_rev, const int *graph_of_node

#define CGR_MODEL_DIMS                                                        \
  float *scratch, float *partial, float *out, int p, int te, int tn, int tb, \
      int F, int Fe, int H, int L, int D, int DN, int act, int mean_aggr,    \
      int mean_pool, int mat_dtype, void *stream

#define CGR_MODEL_ARGS                                                        \
  ModelArgs {                                                                 \
    x, e, senders, edge_nbr, rev, node_inc, graph_nodes, wx, we, be, wc, bc, \
        skips, ws, wxn, ben, wffn, bffn, drop, te, tn, tb, F, Fe, H, L, D,   \
        DN, act, mean_aggr, mean_pool                                         \
  }

// K2: the training step's SSE (out[0]) and gradients from labels and mask.
extern "C" int cgr_fused_model_train(CGR_MODEL_PARAMS, const float* labels,
                                     const float* mask, CGR_MODEL_DIMS) {
  return launch(CGR_MODEL_ARGS,
                BwdArgs{receivers, edge_nbr_rev, graph_of_node, labels, mask,
                        nullptr, scratch, partial},
                out, p, mat_dtype, stream);
}

// K3b: the gradients (out[0] = 0) from the cotangent dpred of the forward.
extern "C" int cgr_fused_model_vjp(CGR_MODEL_PARAMS, const float* dpred,
                                   CGR_MODEL_DIMS) {
  return launch(CGR_MODEL_ARGS,
                BwdArgs{receivers, edge_nbr_rev, graph_of_node, nullptr,
                        nullptr, dpred, scratch, partial},
                out, p, mat_dtype, stream);
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
