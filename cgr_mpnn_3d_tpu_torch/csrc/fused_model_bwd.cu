// Whole-model CGR-MPNN backward as one persistent grid (CUDA C++,
// sm_90a): the training step's compute (K2) and the VJP of the forward
// (K3b) in one __global__, as on the TPU.
//
// Replaces cgr_mpnn_3d_tpu/ops/pallas_model.py::_bwd_kernel, launched there
// by fused_model_train (with_loss: labels and mask in, dpred = 2·mask·(pred
// − y) and the masked SSE derived in-kernel) and by _bwd_call (the custom
// VJP of fused_model: dpred in).  Per pack the kernel replays the forward
// of fused_model_common.cuh (train-mode hash dropout included), then walks
// it backwards and writes the pack's share of the 11 parameter gradients
// (and of the SSE) to its own slice of a partial buffer; a last phase sums
// the slices over packs in pack order.  No atomics, so reruns and resumed
// runs are bit-identical.  The graph inputs need no gradients, so none
// leaves the kernel.
//
// Design.
// * One cooperative launch of as many blocks as fit the card at once
//   (occupancy x SMs).  The step runs as a sequence of phases separated by
//   grid barriers; each phase is cut into items -- a 64 x 64 output tile of
//   a product, a range of rows of an elementwise or gather pass (4 rows up
//   to 32 packs, else 16), a graph of the pooling, or a pack's reduction --
//   of every pack, and block b takes items b, b + grid, b + 2·grid, ...
//   Every output element is written by exactly one item, and an item's
//   arithmetic does not depend on the block that runs it, so the result
//   does not depend on the grid size.  A grid that cannot be co-resident
//   is a launch error, never a hang.
// * Two instantiations of each mat_dtype: one block per SM (no register
//   spill) while the largest tile phases fit the SMs, as at a training
//   batch of four packs; two per SM (128 registers) at a larger batch,
//   where more blocks hide more latency.  The dealing of items, the
//   forward's phases (the replay, shared with K3f), the instantiation's
//   choice, the grid and the phase clock are in fused_model_grid.cuh.
// * Phases (L conv layers; the names of the phase clock):
//     edge_init          h0, pre0 tiles; the mean scales of the pack
//     gather[l], conv[l] messages t_l; t_l·Wc[l] tiles -> pre_l, h
//     readout gather     s;  readout  s·Ws + x·Wxn tiles -> pre_n, hn
//     pool+head          pooled rows and predictions
//     pool adjoint       dpre_n, with dpred and the SSE recomputed from the
//                        predictions; the head's gradients; dben partials
//     readout grads      ds = dpre_n·Wsᵀ tiles into hn's rows; dWxn tiles;
//                        dben; dWs tiles (see below)
//     adjoint+act[l]     the rest of dWs (l = L - 1) or of dWc[l + 1]; the
//                        cotangent of h_l (the incoming-sum adjoint of ds,
//                        or the message adjoint of dt_{l+1}), dropout and
//                        activation -> dpre_l over pre_l; dh0 +=
//                        skip·dpre_l; column and skip partials
//     dt[l]              dt_l = dpre_l·Wc[l]ᵀ tiles into g's rows; dbc[l],
//                        dskips[l]; dWc[l] tiles (see below)
//     edge_init adjoint  the rest of dWc[0]; dpre0 = (dh0 + message adjoint
//                        of dt_0)·act'
//     edge_init grads    dWx, dWe tiles; dbe
//     pack sum           the pack slices summed in pack order
//   A weight gradient feeds nothing but the pack sum, so at a small batch
//   its tiles fill the cotangent phase that can first run them up to one
//   round more than that phase needs, and the rest run in the row phase
//   after it, where most of the grid would otherwise wait; at a large
//   batch they all run in the cotangent phase.
// * Column sums (dbe, dbc, dben) and dskips[l] = Σ dpre_l·h0 are summed per
//   (pack, row item) in row order, then over the items in order by one
//   item per pack.
// * State: per-pack device-memory scratch as before ((2L + 5)·te·H +
//   (3·tn + tb)·H floats, ≈ 6 MB per pack at full width, plus the chunk
//   partials); the backward overwrites the states in place with the
//   cotangents once they are no longer needed.
// * Adjoint gathers without atomics: each gather of the forward is
//   transposed into a gather through the index arrays the packer already
//   carries -- messages through edge_nbr_rev (each contribution scaled by
//   the forward row's 1/degree for mean) minus the rev row, the incoming
//   sum through receivers, pooling through graph_of_node.  x[senders]
//   needs no adjoint: dWx takes the gathered x rows as its transposed
//   operand.  Indices outside the pack count as absent in both directions.
// * Products: the tiles of the forward, with a transposed A operand for
//   the weight gradients (Aᵀ·B over the pack's rows) and a transposed B for
//   the cotangents through the weights (dpre·Wᵀ); in f32 the tile's K-chunk
//   order is that of one block per pack, so the weight gradients equal
//   that kernel's bit for bit.
// * bf16 (mat_dtype 1, the TPU kernel at mat_dtype=bf16): the replay is the
//   forward's bf16 instantiation, and every backward product, gather and
//   head term rounds its operands to bf16 as _bwd_kernel does -- dpred in
//   the head products, dpooled, dpre_n and ds, each layer's dpre and dt,
//   dpre0 -- with the bf16 mean scales; the products run on the tensor
//   cores (f32 sums).  The loss, dpred, the ReLU mask, the bias and skip
//   gradients and dh0 stay f32, as do the per-pack partials and their sum.
//
// Bound.  Per pack the replay needs the forward's f32 FMAs (≈ 0.43 GFLOP at
// full width, x part of edge_init once per node) and the backward about two
// more products of the same size per dense layer (the cotangent through the
// weights and the weight gradient), ≈ 1.2 GFLOP per pack in all, against a
// few hundred KB of input and ≈ 4.1 MB of partial gradients per pack: bound
// by f32 FMA throughput outside the tensor cores.  In bf16 the products are
// tensor-core work (bound 15x lower than f32's), and the staging loops, the
// gathers and the elementwise passes over the pack's states set the time.

#include "fused_model_grid.cuh"

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

// Row chunks of a pack's column and skip partials, at most.
__host__ __device__ inline int chunks_of(int te, int tn) {
  return row_items(te > tn ? te : tn, kRowsSmall);
}

// Offsets (floats) of one pack's scratch.
struct ScratchLayout {
  size_t pre0, h0, t, pre, h, g, dh0, s, pre_n, hn, pooled, preds, escale,
      nscale, gscale, colpart, skpart, total;
  __host__ __device__ ScratchLayout(int te, int tn, int tb, int H, int L) {
    const size_t teH = static_cast<size_t>(te) * H,
                 tnH = static_cast<size_t>(tn) * H;
    size_t o = 0;
    pre0 = o;    o += teH;
    h0 = o;      o += teH;
    t = o;       o += L * teH;
    pre = o;     o += L * teH;
    h = o;       o += teH;
    g = o;       o += teH;
    dh0 = o;     o += teH;
    s = o;       o += tnH;
    pre_n = o;   o += tnH;
    hn = o;      o += tnH;
    pooled = o;  o += static_cast<size_t>(tb) * H;
    preds = o;   o += tb;
    escale = o;  o += te;
    nscale = o;  o += tn;
    gscale = o;  o += tb;
    colpart = o; o += static_cast<size_t>(chunks_of(te, tn)) * H;
    skpart = o;  o += chunks_of(te, tn);
    total = o;
  }
};

struct BwdArgs {
  const int *receivers, *edge_nbr_rev, *graph_of_node;
  const float *labels, *mask;  // with the loss (K2), else nullptr
  const float* dpred;          // without the loss (K3b), else nullptr
  float *scratch, *partial, *out;
  int p;
};

// One pack's scratch and partial slice.
struct Pack {
  int q, eb, nb, gb;
  float *pre0, *h0, *t, *pre, *h, *g, *dh0, *s, *pre_n, *hn, *pooled, *preds,
      *escale, *nscale, *gscale, *colpart, *skpart, *part;
  __device__ Pack(const ModelArgs& a, const BwdArgs& b,
                  const ScratchLayout& sl, const GradLayout& gl, int q_)
      : q(q_), eb(q_ * a.te), nb(q_ * a.tn), gb(q_ * a.tb) {
    float* base = b.scratch + static_cast<size_t>(q) * sl.total;
    pre0 = base + sl.pre0;
    h0 = base + sl.h0;
    t = base + sl.t;
    pre = base + sl.pre;
    h = base + sl.h;
    g = base + sl.g;
    dh0 = base + sl.dh0;
    s = base + sl.s;
    pre_n = base + sl.pre_n;
    hn = base + sl.hn;
    pooled = base + sl.pooled;
    preds = base + sl.preds;
    escale = base + sl.escale;
    nscale = base + sl.nscale;
    gscale = base + sl.gscale;
    colpart = base + sl.colpart;
    skpart = base + sl.skpart;
    part = b.partial + static_cast<size_t>(q) * gl.total;
  }
  __device__ FwdState fwd(const ModelArgs& a) const {
    const size_t teH = static_cast<size_t>(a.te) * a.H;
    return FwdState{pre0, h0, t, pre, h, s, pre_n, hn, pooled, preds, teH,
                    teH};
  }
};

// out[r] = mean_colscale(entries of ids[r, :] inside [lo, lo + n)) when
// `mean`, else 1: the forward's scale of row r.
template <bool kBf16>
__device__ void row_scales(const int* __restrict__ ids, int D, int lo, int n,
                           int R, bool mean, float* out) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    int count = 0;
    for (int d = 0; d < D; ++d) {
      const int j = ids[static_cast<size_t>(r) * D + d] - lo;
      count += (j >= 0 && j < n);
    }
    out[r] = mean ? mean_colscale<kBf16>(count) : 1.f;
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

// out[c] = Σ_k part[k, c] over the chunks k in order.
__device__ void sum_chunks(const float* part, int chunks, int H, float* out) {
  for (int c = threadIdx.x; c < H; c += kThreads) {
    float s = 0.f;
    for (int k = 0; k < chunks; ++k) s += part[static_cast<size_t>(k) * H + c];
    out[c] = s;
  }
}

// The cotangent of pack graph q's prediction: 2·mask·(pred − y) with the
// loss, else the given dpred.
__device__ __forceinline__ float dpred_of(const BwdArgs& b, const Pack& k,
                                          int q) {
  if (b.labels == nullptr) return b.dpred[k.gb + q];
  const float err = (k.preds[q] - b.labels[k.gb + q]) * b.mask[k.gb + q];
  return 2.f * err;
}

// The cotangent of h_l (l = L: of the readout's input) at edge row r,
// column c: for l = L the incoming-sum adjoint of ds (held in hn's rows),
// g[e] = scale_r·ds[r], r = receivers[e]; else the message adjoint of
// dt_l (held in g's rows), Σ_{e in edge_nbr_rev[r]} scale_e·dt[e] −
// dt[rev[r]].
template <bool kBf16>
__device__ __forceinline__ float cotangent(const ModelArgs& a,
                                           const BwdArgs& b, const Pack& k,
                                           int l, int r, int c) {
  const int H = a.H;
  if (l == a.L) {
    const int n = b.receivers[k.eb + r] - k.nb;
    return (n >= 0 && n < a.tn)
               ? k.nscale[n] * operand<kBf16>(k.hn[static_cast<size_t>(n) * H + c])
               : 0.f;
  }
  const int* nbr = b.edge_nbr_rev + static_cast<size_t>(k.eb + r) * a.D;
  float sum = 0.f;
  for (int d = 0; d < a.D; ++d) {
    const int j = nbr[d] - k.eb;
    if (j >= 0 && j < a.te)
      sum += k.escale[j] * operand<kBf16>(k.g[static_cast<size_t>(j) * H + c]);
  }
  const int j = a.rev[k.eb + r] - k.eb;
  if (j >= 0 && j < a.te)
    sum -= operand<kBf16>(k.g[static_cast<size_t>(j) * H + c]);
  return sum;
}

// Item of the pool adjoint: dpre_n over node rows [r0, r1) and their
// column partials.
template <bool kBf16>
__device__ void pool_adjoint_rows(const ModelArgs& a, const BwdArgs& b,
                                  const Pack& k, int chunk, int rows) {
  const int H = a.H, r0 = chunk * rows,
            r1 = r0 + rows < a.tn ? r0 + rows : a.tn;
  for (int c = threadIdx.x; c < H; c += kThreads) {
    float cs = 0.f;
    for (int n = r0; n < r1; ++n) {
      const size_t i = static_cast<size_t>(n) * H + c;
      const int q = b.graph_of_node[k.nb + n] - k.gb;
      const float dhn =
          (q >= 0 && q < a.tb)
              ? k.gscale[q] * operand<kBf16>(operand<kBf16>(dpred_of(b, k, q)) *
                                             operand<kBf16>(a.wffn[c]))
              : 0.f;
      const float v = dhn * k_dact(a.act, k.pre_n[i]);
      k.pre_n[i] = v;
      cs += v;
    }
    k.colpart[static_cast<size_t>(chunk) * H + c] = cs;
  }
}

// Item of the pool adjoint: the pack's SSE and the head's gradients.
template <bool kBf16>
__device__ void head_grads(const ModelArgs& a, const BwdArgs& b,
                           const GradLayout& gl, const Pack& k) {
  const int H = a.H;
  if (threadIdx.x == 0) {
    float sse = 0.f, db = 0.f;
    for (int q = 0; q < a.tb; ++q) {
      if (b.labels != nullptr) {
        const float err =
            (k.preds[q] - b.labels[k.gb + q]) * b.mask[k.gb + q];
        sse += err * err;
      }
      db += dpred_of(b, k, q);
    }
    k.part[gl.sse] = sse;
    k.part[gl.dbffn] = db;
  }
  for (int c = threadIdx.x; c < H; c += kThreads) {
    float v = 0.f;
    for (int q = 0; q < a.tb; ++q)
      v = fmaf(operand<kBf16>(k.pooled[static_cast<size_t>(q) * H + c]),
               operand<kBf16>(dpred_of(b, k, q)), v);
    k.part[gl.dwffn + c] = v;
  }
}

// Item of adjoint+act[l]: dpre_l over edge rows [r0, r1) from the
// cotangent of h_l, dropout and the activation; dh0 += skip·dpre_l; the
// chunk's column and skip partials.
template <bool kBf16>
__device__ void layer_adjoint_rows(const ModelArgs& a, const BwdArgs& b,
                                   const Pack& k, int l, int chunk,
                                   int rows, float* red) {
  const int H = a.H, r0 = chunk * rows,
            r1 = r0 + rows < a.te ? r0 + rows : a.te;
  const size_t teH = static_cast<size_t>(a.te) * H;
  float* dpre = k.pre + l * teH;
  const Dropout drop = layer_dropout(a.drop, a.L, l, k.q);
  const float skip = a.skips[l];
  const bool first = l == a.L - 1;
  float dsk = 0.f;
  for (int c = threadIdx.x; c < H; c += kThreads) {
    float cs = 0.f;
    for (int r = r0; r < r1; ++r) {
      const size_t i = static_cast<size_t>(r) * H + c;
      float gg = cotangent<kBf16>(a, b, k, l + 1, r, c);
      if (drop.on) gg = drop.kept(r, c) ? gg * drop.scale : 0.f;
      const float v = gg * k_dact(a.act, dpre[i]);
      dpre[i] = v;
      dsk = fmaf(v, k.h0[i], dsk);
      k.dh0[i] = fmaf(skip, v, first ? 0.f : k.dh0[i]);
      cs += v;
    }
    k.colpart[static_cast<size_t>(chunk) * H + c] = cs;
  }
  const float s = block_sum(dsk, red);
  if (threadIdx.x == 0) k.skpart[chunk] = s;
}

// Item of the edge_init adjoint: dpre0 = (dh0 + cotangent of h0)·act'
// over edge rows [r0, r1), and the chunk's column partials.
template <bool kBf16>
__device__ void edge_init_adjoint_rows(const ModelArgs& a, const BwdArgs& b,
                                       const Pack& k, int chunk, int rows) {
  const int H = a.H, r0 = chunk * rows,
            r1 = r0 + rows < a.te ? r0 + rows : a.te;
  for (int c = threadIdx.x; c < H; c += kThreads) {
    float cs = 0.f;
    for (int r = r0; r < r1; ++r) {
      const size_t i = static_cast<size_t>(r) * H + c;
      const float d0 = a.L > 0 ? k.dh0[i] : 0.f;
      const float v = (d0 + cotangent<kBf16>(a, b, k, 0, r, c)) *
                      k_dact(a.act, k.pre0[i]);
      k.pre0[i] = v;
      cs += v;
    }
    k.colpart[static_cast<size_t>(chunk) * H + c] = cs;
  }
}

// Tile j of the weight gradient whose operands the phase before gave:
// dWc[l] = t_lᵀ·dpre_l for l < L, dWs = sᵀ·dpre_n for l = L.
template <bool kBf16>
__device__ void weight_tile(const ModelArgs& a, const Pack& k,
                            const GradLayout& gl, int l, int j,
                            SmemOf<kBf16>& sm) {
  const int H = a.H;
  const size_t teH = static_cast<size_t>(a.te) * H;
  if (l == a.L)
    gemm_tile<kBf16, true, false>(
        Operands{Rows{k.s, H, nullptr, 0, 0}, k.pre_n, H, a.tn}, nullptr, H,
        H, j, StoreEpi{k.part + gl.dws, H}, sm);
  else
    gemm_tile<kBf16, true, false>(
        Operands{Rows{k.t + l * teH, H, nullptr, 0, 0}, k.pre + l * teH, H,
                 a.te},
        nullptr, H, H, j,
        StoreEpi{k.part + gl.dwc + static_cast<size_t>(l) * H * H, H}, sm);
}

// Weight tiles that a tile phase of n items takes (the rest go to the
// next phase, beside its rows): at a large batch (four rounds of the grid
// or more) all `tiles`; else as many as fill the last round's free slots
// and one more round, so that the next phase keeps few tiles.
__device__ __forceinline__ int fill_of(int n, int tiles) {
  const int G = gridDim.x;
  if (n >= 4 * G) return tiles;
  const int free = (G - n % G) % G + G;
  return free < tiles ? free : tiles;
}

// A tile phase whose packs have `own` items each and take `fill` of the
// weight gradient's p·t_w tiles (pack-major order of the tiles):
// own(q, j) and weight(q, j) for this block's items.  With every tile
// (a large batch) the items run pack by pack, a pack's weight tiles
// first, so that the tiles that read the same rows run together; else
// every pack's own items first, then the tiles.
template <class Own, class Weight>
__device__ void own_and_weights(int p, int own, int t_w, int fill,
                                Own&& own_fn, Weight&& weight_fn) {
  if (fill == p * t_w) {
    items(p * (own + t_w), [&](int it) {
      const int q = it / (own + t_w), j = it % (own + t_w);
      if (j < t_w)
        weight_fn(q, j);
      else
        own_fn(q, j - t_w);
    });
  } else {
    items(p * own + fill, [&](int it) {
      if (it < p * own)
        own_fn(it / own, it % own);
      else
        weight_fn((it - p * own) / t_w, (it - p * own) % t_w);
    });
  }
}

// kBlocks: the blocks an SM holds at once, as the launch bounds make
// ptxas fit the registers (1 at a small batch, where a few hundred tiles
// per phase meet one block per SM and no spill; 2 at a large one).
template <bool kBf16, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
    fused_model_bwd_kernel(const ModelArgs a, const BwdArgs b) {
  __shared__ SmemOf<kBf16> sm;
  __shared__ float red[kThreads];
  const cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int H = a.H, te = a.te, tn = a.tn, tb = a.tb, F = a.F, L = a.L,
            p = b.p, rows = rows_per_item(p);
  const ScratchLayout sl(te, tn, tb, H, L);
  const GradLayout gl(F, a.Fe, H, L);
  const int t_e = tiles_of(te, H), t_n = tiles_of(tn, H),
            t_hh = tiles_of(H, H), t_fh = tiles_of(F, H),
            t_eh = tiles_of(a.Fe, H), r_e = row_items(te, rows),
            r_n = row_items(tn, rows);
  auto pack = [&](int q) { return Pack(a, b, sl, gl, q); };
  CGR_STAMP(0, -1);

  // replay: the forward's phases, with the mean scales beside edge_init
  forward_phases<kBf16>(
      a, p, [&](int q) { return pack(q).fwd(a); }, 1,
      [&](int q, int) {
        const Pack k = pack(q);
        row_scales<kBf16>(a.edge_nbr + static_cast<size_t>(k.eb) * a.D, a.D,
                          k.eb, te, te, a.mean_aggr != 0, k.escale);
        row_scales<kBf16>(a.node_inc + static_cast<size_t>(k.nb) * a.D, a.D,
                          k.eb, te, tn, a.mean_aggr != 0, k.nscale);
        row_scales<kBf16>(a.graph_nodes + static_cast<size_t>(k.gb) * a.DN,
                          a.DN, k.nb, tn, tb, a.mean_pool != 0, k.gscale);
      },
      sm);
  grid.sync();
  CGR_STAMP(6, -1);

  // the loss, the head and the pooling adjoint
  items(p * (r_n + 1), [&](int it) {
    const int q = it / (r_n + 1), j = it % (r_n + 1);
    const Pack k = pack(q);
    if (j < r_n)
      pool_adjoint_rows<kBf16>(a, b, k, j, rows);
    else
      head_grads<kBf16>(a, b, gl, k);
  });
  grid.sync();
  CGR_STAMP(7, -1);

  // ds = dpre_n·Wsᵀ into hn's rows (hn is not read again), dWxn, dben, and
  // the first tiles of dWs (fill_of).  A weight gradient feeds nothing but
  // the pack sum: the tiles of dWs (dWc[l]) that do not fit here run
  // beside the next phase's rows.
  int fill = fill_of(p * (t_n + t_fh + 1), p * t_hh);
  own_and_weights(
      p, t_n + t_fh + 1, t_hh, fill,
      [&](int q, int j) {
        const Pack k = pack(q);
        if (j < t_n)
          gemm_tile<kBf16, false, true>(
              Operands{Rows{k.pre_n, H, nullptr, 0, 0}, a.ws, H, H}, nullptr,
              tn, H, j, StoreEpi{k.hn, H}, sm);
        else if ((j -= t_n) < t_fh)
          gemm_tile<kBf16, true, false>(
              Operands{Rows{a.x + static_cast<size_t>(k.nb) * F, F, nullptr,
                            0, 0},
                       k.pre_n, H, tn},
              nullptr, F, H, j, StoreEpi{k.part + gl.dwxn, H}, sm);
        else
          sum_chunks(k.colpart, r_n, H, k.part + gl.dben);
      },
      [&](int q, int j) { weight_tile<kBf16>(a, pack(q), gl, L, j, sm); });
  grid.sync();
  CGR_STAMP(8, -1);

  // the conv stack, in reverse; dt_l goes into g's rows.  Each row phase
  // first finishes the weight tiles (dWs, then dWc[l + 1]) that the tile
  // phase before left.
  for (int l = L - 1; l >= 0; --l) {
    const int rest = p * t_hh - fill;
    items(rest + p * r_e, [&](int it) {
      if (it < rest) {
        it += fill;
        weight_tile<kBf16>(a, pack(it / t_hh), gl, l + 1, it % t_hh, sm);
      } else {
        it -= rest;
        layer_adjoint_rows<kBf16>(a, b, pack(it / r_e), l, it % r_e, rows,
                                  red);
      }
    });
    grid.sync();
    CGR_STAMP(9, l);
    fill = fill_of(p * (t_e + 1), p * t_hh);
    own_and_weights(
        p, t_e + 1, t_hh, fill,
        [&](int q, int j) {
          const Pack k = pack(q);
          if (j < t_e) {
            gemm_tile<kBf16, false, true>(
                Operands{Rows{k.pre + l * static_cast<size_t>(te) * H, H,
                              nullptr, 0, 0},
                         a.wc + static_cast<size_t>(l) * H * H, H, H},
                nullptr, te, H, j, StoreEpi{k.g, H}, sm);
          } else {
            sum_chunks(k.colpart, r_e, H,
                       k.part + gl.dbc + static_cast<size_t>(l) * H);
            if (threadIdx.x == 0) {
              float s = 0.f;
              for (int c = 0; c < r_e; ++c) s += k.skpart[c];
              k.part[gl.dskips + l] = s;
            }
          }
        },
        [&](int q, int j) { weight_tile<kBf16>(a, pack(q), gl, l, j, sm); });
    grid.sync();
    CGR_STAMP(10, l);
  }

  // edge_init, after the rest of dWc[0] (of dWs when there is no conv
  // layer)
  const int rest = p * t_hh - fill;
  items(rest + p * r_e, [&](int it) {
    if (it < rest) {
      it += fill;
      weight_tile<kBf16>(a, pack(it / t_hh), gl, 0, it % t_hh, sm);
    } else {
      it -= rest;
      edge_init_adjoint_rows<kBf16>(a, b, pack(it / r_e), it % r_e, rows);
    }
  });
  grid.sync();
  CGR_STAMP(11, -1);
  items(p * (t_fh + t_eh + 1), [&](int it) {
    const int q = it / (t_fh + t_eh + 1);
    int j = it % (t_fh + t_eh + 1);
    const Pack k = pack(q);
    if (j < t_fh)
      gemm_tile<kBf16, true, false>(
          Operands{Rows{a.x + static_cast<size_t>(k.nb) * F, F,
                        a.senders + k.eb, k.nb, tn},
                   k.pre0, H, te},
          nullptr, F, H, j, StoreEpi{k.part + gl.dwx, H}, sm);
    else if ((j -= t_fh) < t_eh)
      gemm_tile<kBf16, true, false>(
          Operands{Rows{a.e + static_cast<size_t>(k.eb) * a.Fe, a.Fe,
                        nullptr, 0, 0},
                   k.pre0, H, te},
          nullptr, a.Fe, H, j, StoreEpi{k.part + gl.dwe, H}, sm);
    else
      sum_chunks(k.colpart, r_e, H, k.part + gl.dbe);
  });
  grid.sync();
  CGR_STAMP(12, -1);

  // out[i] = Σ_q part[q, i] over the packs, in pack order
  const long long G = static_cast<long long>(gl.total);
  constexpr int kSumChunk = 8 * kThreads;
  for (long long c0 = static_cast<long long>(blockIdx.x) * kSumChunk; c0 < G;
       c0 += static_cast<long long>(gridDim.x) * kSumChunk) {
    for (long long i = c0 + threadIdx.x; i < G && i < c0 + kSumChunk;
         i += kThreads) {
      float s = 0.f;
      for (int q = 0; q < p; ++q) s += b.partial[static_cast<size_t>(q) * G + i];
      b.out[i] = s;
    }
  }
#ifdef CGR_PHASE_CLOCK
  grid.sync();
#endif
  CGR_STAMP(13, -1);
}

Instances kFns = {
    {reinterpret_cast<const void*>(&fused_model_bwd_kernel<false, 1>),
     reinterpret_cast<const void*>(&fused_model_bwd_kernel<false, 2>)},
    {reinterpret_cast<const void*>(&fused_model_bwd_kernel<true, 1>),
     reinterpret_cast<const void*>(&fused_model_bwd_kernel<true, 2>)}};

int launch(const ModelArgs& a, BwdArgs b, float* out, int p, int mat_dtype,
           void* stream) {
  b.out = out;
  b.p = p;
  ModelArgs args = a;
  void* params[] = {&args, &b};
  return launch_grid(kFns, mat_dtype, p, a.te, a.H, params, stream);
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

// The grid of a launch at mat_dtype on p packs of te edge rows and width
// H, on the current device: returns the blocks (or minus a CUDA error
// code) and writes the blocks per SM and the SMs.
extern "C" int cgr_fused_model_bwd_grid(int mat_dtype, int p, int te, int H,
                                        int* per_sm, int* sms) {
  const void* fn = nullptr;
  int grid = 0;
  const int err = grid_of(kFns, mat_dtype, p, te, H, &fn, &grid, per_sm,
                          sms);
  return err != 0 ? -err : grid;
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
                        nullptr, scratch, partial, nullptr, 0},
                out, p, mat_dtype, stream);
}

// K3b: the gradients (out[0] = 0) from the cotangent dpred of the forward.
extern "C" int cgr_fused_model_vjp(CGR_MODEL_PARAMS, const float* dpred,
                                   CGR_MODEL_DIMS) {
  return launch(CGR_MODEL_ARGS,
                BwdArgs{receivers, edge_nbr_rev, graph_of_node, nullptr,
                        nullptr, dpred, scratch, partial, nullptr, 0},
                out, p, mat_dtype, stream);
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
