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
// mat = 1 is the TPU kernels' mat_dtype bf16: xa, xb, dxa and dxb are bf16
// (the model's x, e and h are bf16 there, and dxa, dxb take their dtype),
// every operand is rounded to bf16 where it is read, the products run on
// the tensor cores and the mean scale is bf16(1 / degree); the output and
// its cotangent are at out_dtype (out_bf16: bf16 for edge_init's h0, f32
// for the readout); dpre, dWa, dWb and db stay f32.
//
// Design.  The TPU kernel builds G as a one-hot matrix per pack and keeps
// every operand of a pack in VMEM.  Here each direction is one cooperative
// launch over the whole card on conv_grid.cuh's machinery (its
// cp.async-pipelined tile, items dealt at a fixed stride, grid barriers):
//
//   forward    gather: t1 = G·xa (+ xr) into device scratch at a padded
//              row stride (zeros in the pad); xb copied at a padded
//              stride when its rows are not whole 16-byte chunks; with
//              bf16 products Wa and Wb rounded to bf16
//              | grid barrier |
//              product: tiles of t1·Wa + xb·Wb (two operand pairs through
//              one accumulator, pair 1's k then pair 2's), bias and act
//              | | K11: the group pool's (group, chunk) partial sums
//              | | K11 with more than one chunk: their sums in chunk order
//   backward   t1 and each row's scale recomputed, the xb copy, the bf16
//              weights; ReLU: dpre = g where out > 0 (K11: g + the pool's
//              cotangent of the row's group, folded into the read), and
//              its bf16 copy
//              | | SiLU, GELU: dpre from the recomputed pre-activation
//              tiles
//              | | the tiles of dxb = dpre·Wbᵀ and dt = dpre·Waᵀ, the
//              split-K partial tiles of dWa and dWb, db's column partials
//              | | the sums of dWa, dWb and db in partial order; dxa, the
//              adjoint gather of dt through adj
//
// Gᵀ is a gather through the transposed ELL array `adj` [p·ca, Dadj]
// (node_out for edge_init, receivers for the readout), each entry scaled
// by its forward row's scale_r: no atomics.  The weight gradients are
// split-K products over S fixed row ranges whose partials are summed in
// split order, so reruns are bit-identical, the result does not depend on
// the grid, and every output has the bits of the earlier design (a gather
// launch and one 64 x 64 tile a block of mma_tile / mma_tile_bf16, then
// split-K launches and their sums): each output's arithmetic is that
// design's.
//
// Bound.  Per call the products need 2·rows·(FA + FB)·H multiply-adds
// (forward; about three times that backward) against a few hundred bytes
// per row, so at the model's widths (FA, FB, H ≥ 14, H = 400) the kernel is
// bound by the products (f32 FMA outside the tensor cores, 67 TFLOP/s, or
// the bf16 tensor cores), not by memory.
//
// The edge-partitioned readout, the entry points cgr_gather_linear_r_*:
// K10 (pallas_glin.py::_fwd_call_r, _bwd_call_r) and, with the pool on,
// K11 (_fwd_call_pool, _bwd_call_pool), which parallel/ep_pack.py runs once
// per EP forward.  xr [p·R, FA] (f32, aligned with the output rows: the
// received remote partials of the owned node slots) joins the gathered
// sum before the product,
//
//   out  = act((G·xa + xr)·Wa + xb·Wb + b),      dxr = dpre·Waᵀ,
//
// and K11 also writes the per-pack group pool pool[q] = Σ_{n ∈
// pool_ell[q]} out[n] [p·GP, H] through the per-group node ELL (the
// untransposed pool_t), as an ordered split sum over chunks of the ELL row
// (a group can hold thousands of entries, a long chain's nodes, which one
// thread per column would walk alone); its backward reads g + gpool[group
// of the row] (through node_group, the transpose).  The gather takes xr
// as its extra term, unrounded, dt is written straight into dxr, and the
// rest is K5's.  mat = 1 is K5's bf16 with the readout's f32 output: xa,
// xb, dxa and dxb bf16; xr, dxr, out, g, the pool and its cotangent f32.
// As in pallas_glin.py at mat_dtype bf16, xr joins the gathered sum in f32
// and t1 is rounded once (:316-319), the pool sums bf16(out) and the
// backward adds bf16(gpool) (:497, :527), and dxr is the f32 dt =
// bf16(dpre)·bf16(Wa)ᵀ, rounded again where dxa gathers it.
//
// tools/glin_phases.py builds this with CGR_PHASE_CLOCK (thread 0 of block
// 0 stamps %globaltimer after each grid barrier, phase ids in the stamp's
// layer field: 1 gather, 2 pre-activation tiles, 5 products, 6 pool
// partials, 7 pool sums, 8 block 0's own product tiles, 9 the end) and
// with CGR_TILE_NO_LOAD or CGR_TILE_NO_FMA (conv_grid.cuh's probes).  The
// shipped build carries none of them.

#include "conv_grid.cuh"

namespace {

using namespace cgr;

// t1's and xb's padded row stride: a multiple of kGlinPad elements (whole
// 16-byte chunks at f32 and bf16)
constexpr int kGlinPad = 8;
// K11's pool: each group's pool_ell row [DN] is cut into chunks of
// kPoolChunk entries (their count a function of DN alone)
constexpr int kPoolChunk = 32;    // entries of a chunk: one warp's ballot
constexpr int kDpreChunk = 4 * kThreads;  // elements of a dpre item
// units of four columns a thread gathers at once in the forward where rows
// are not whole vectors (edge_init's t1: x's 270 columns); the backward
// gathers one element a thread at a time (four units there cost the
// kernel its registers: spills in its product tiles)
constexpr int kGatherUnits = 4;

__host__ __device__ __forceinline__ int padded(int n) {
  return (n + kGlinPad - 1) / kGlinPad * kGlinPad;
}

// Whether xb is copied at its padded stride: where its rows are not whole
// 16-byte chunks (an xb whose rows are is read in place).
__host__ __device__ __forceinline__ bool xb_copied(int FB) {
  return padded(FB) != FB;
}

// Rows [r0, r1) of row item j: zeros in columns [W, ld) of out.
template <class T>
__device__ __forceinline__ void pad_item(T* out, int W, long long ld,
                                         int rows, int j, int per) {
  if (ld == W) return;
  int r0, r1;
  row_span(j, per, rows, r0, r1);
  const int w = static_cast<int>(ld) - W;
  for (int i = threadIdx.x; i < (r1 - r0) * w; i += kThreads)
    out[(r0 + i / w) * ld + W + i % w] = from_f32<T>(0.f);
}

// Row item j of dst [rows, ld] = src [rows, W], zeros in the pad; four
// elements a thread at once, their loads first.
template <class T>
__device__ __forceinline__ void copy_item(const T* src, T* dst, int W,
                                          int ld, int rows, int j, int per) {
  constexpr int U = 4;
  int r0, r1;
  row_span(j, per, rows, r0, r1);
  const int n = (r1 - r0) * ld;
  for (int i0 = threadIdx.x; i0 < n; i0 += U * kThreads) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads, r = r0 + i / ld, c = i % ld;
      v[u] = i < n && c < W ? src[static_cast<long long>(r) * W + c]
                            : from_f32<T>(0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n) dst[static_cast<long long>(r0 + i / ld) * ld + i % ld] = v[u];
    }
  }
}

// The cotangent of out[m, n]: g, plus (K11) the pool's cotangent of row
// m's group when that lies in the GP groups of its pack, rounded as an
// operand (g + gpool in f32, as the earlier design's dout).
template <bool kBf16, class O>
struct Cotangent {
  const O* g;
  const float* gpool;      // [p·GP, H], or null
  const int* node_group;   // [p·R]
  int R, GP, H;
  __device__ __forceinline__ float operator()(long long m, int n) const {
    float v = to_f32(g[m * H + n]);
    if (gpool != nullptr) {
      const long long lo = (m / R) * GP, q = node_group[m] - lo;
      if (q >= 0 && q < GP) v += operand<kBf16>(gpool[(lo + q) * H + n]);
    }
    return v;
  }
};

// dpre = cot·act'(acc + bias): the backward's pre-activation recomputed
// (SiLU, GELU), with its bf16 copy when dpre16 is set.
template <bool kBf16, class O>
struct DpreEpi {
  const float* bias;
  Cotangent<kBf16, O> cot;
  int act;
  float* dpre;
  __nv_bfloat16* dpre16;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    const size_t o = static_cast<size_t>(m) * cot.H + n;
    const float v = cot(m, n) * k_dact(act, acc + bias[n]);
    dpre[o] = v;
    if (dpre16 != nullptr) dpre16[o] = __float2bfloat16_rn(v);
  }
};

// Item j of ReLU's dpre = cot where out > 0, else 0, over rows·H elements
// (and its bf16 copy): four elements a thread, their loads first.
template <bool kBf16, class O>
__device__ __forceinline__ void relu_dpre_item(const O* out,
                                               const Cotangent<kBf16, O>& cot,
                                               long long n, float* dpre,
                                               __nv_bfloat16* dpre16, int j) {
  constexpr int U = kDpreChunk / kThreads;
  const long long i0 = static_cast<long long>(j) * kDpreChunk + threadIdx.x;
  float x[U], g[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = i0 + u * kThreads;
    if (i < n) x[u] = to_f32(out[i]), g[u] = cot(i / cot.H, i % cot.H);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = i0 + u * kThreads;
    if (i >= n) continue;
    const float v = x[u] > 0.f ? g[u] : 0.f;
    dpre[i] = v;
    if (dpre16 != nullptr) dpre16[i] = __float2bfloat16_rn(v);
  }
}

// K11's pool: item `it` = (group, chunk) of the ordered split sum.  Warp 0
// keeps the chunk's entries inside the group's pack, in entry order, and
// the block sums their rows of out in that order (each operand rounded as
// a gather's) into part[group, chunk, :], marking in used[group, chunk]
// whether the chunk had an entry; with one chunk (used null) part is the
// pool itself.
template <bool kBf16>
__device__ __forceinline__ void pool_part_item(const float* out, int R, int H,
                                               const int* pool_ell, int GP,
                                               int DN, int chunks,
                                               long long it, float* part,
                                               int* used, int* rows,
                                               int* n_rows) {
  const long long g = it / chunks, lo = (g / GP) * R;
  const int lane = threadIdx.x;
  if (lane < kPoolChunk) {
    const int d = static_cast<int>(it % chunks) * kPoolChunk + lane;
    const long long j = d < DN ? pool_ell[g * DN + d] - lo : -1;
    const bool in = j >= 0 && j < R;
    const unsigned mask = __ballot_sync(0xffffffffu, in);
    if (in) rows[__popc(mask & ((1u << lane) - 1u))] = static_cast<int>(j);
    if (lane == 0) *n_rows = __popc(mask);
  }
  __syncthreads();
  const int n = *n_rows;
  if (used != nullptr && threadIdx.x == 0) used[it] = n > 0;
  if (n > 0 || used == nullptr) {
    for (int c = threadIdx.x; c < H; c += kThreads) {
      float sum = 0.f;
#pragma unroll 8
      for (int i = 0; i < n; ++i)
        sum += operand<kBf16>(out[(lo + rows[i]) * H + c]);
      part[it * H + c] = sum;
    }
  }
  __syncthreads();  // rows and n_rows are the next item's
}

// Chunk j of pool[i] = Σ over the used chunks of group i / H, in chunk
// order, over groups·H elements.
__device__ __forceinline__ void pool_sum_item(const float* part,
                                              const int* used,
                                              long long groups, int chunks,
                                              int H, float* pool, int j) {
  const long long n = groups * H;
  const long long end = (j + 1LL) * kConvChunk < n ? (j + 1LL) * kConvChunk : n;
  for (long long i = static_cast<long long>(j) * kConvChunk + threadIdx.x;
       i < end; i += kThreads) {
    const long long g = i / H;
    float s = 0.f;
    for (int k = 0; k < chunks; ++k)
      if (used[g * chunks + k]) s += part[(g * chunks + k) * H + i % H];
    pool[i] = s;
  }
}

// ---------------------------------------------------------------- forward

template <bool kBf16, class O>
struct FwdArgs {
  using E = Elem<kBf16>;
  GatherArgs<E, E> t1;     // t1 = G·xa (+ xr) at row stride t1.ldo
  const E* xb;
  E* xbp;                  // xb at its padded stride (null: in place)
  const float *wa, *wb;
  E *wa16, *wb16;          // bf16: Wa, Wb rounded (scratch)
  LayerEpi<O> epi;
  // K11's pool (pool_ell null: none)
  const int* pool_ell;
  float *pool, *part;
  int* used;
  int GP, DN, chunks;
  int p, FA, FB, H;
};

template <bool kBf16, int BMt, class O>
__global__ void __launch_bounds__(kThreads, 2) glin_fwd_kernel(const FwdArgs<kBf16, O> a) {
  using E = Elem<kBf16>;
  extern __shared__ __align__(16) char smem[];
  __shared__ int pool_rows[kPoolChunk];
  __shared__ int pool_n;
  CGR_STAMP(0, -1);
  const cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int rows = static_cast<int>(a.t1.rows), per = rows_per_item(a.p);
  const int FAp = static_cast<int>(a.t1.ld_out()), FBp = padded(a.FB);
  const long long na = static_cast<long long>(a.FA) * a.H,
                  nb = static_cast<long long>(a.FB) * a.H;
  const int n1[4] = {row_items(rows, per),
                     a.xbp != nullptr ? row_items(rows, per) : 0,
                     kBf16 ? chunks_of(na) : 0, kBf16 ? chunks_of(nb) : 0};
  phase_items(n1, [&](int k, int j) {
    if (k == 0) {
      gather_item<kBf16, kGatherUnits>(a.t1, j, per);
      pad_item(a.t1.out, a.FA, FAp, rows, j, per);
    } else if (k == 1) {
      copy_item(a.xb, a.xbp, a.FB, FBp, rows, j, per);
    } else if constexpr (kBf16) {
      if (k == 2)
        round_item(a.wa, a.wa16, na, j);
      else
        round_item(a.wb, a.wb16, nb, j);
    }
  });
  grid.sync();
  CGR_STAMP(1, 1);
  const bool copied = a.xbp != nullptr;
  const TilePairs<E, 2> pairs{
      {{a.t1.out, FAp, weights<kBf16>(a.wa, a.wa16), a.H, a.FA, true},
       {copied ? a.xbp : a.xb, copied ? FBp : a.FB,
        weights<kBf16>(a.wb, a.wb16), a.H, a.FB, copied}}};
  items(conv_tiles<BMt>(rows, a.H), [&](int it) {
    conv_tile_pairs<kBf16, BMt, false, false>(pairs, rows, a.H, it, a.epi,
                                              smem);
  });
#ifdef CGR_PHASE_CLOCK
  __syncthreads();
  CGR_STAMP(1, 8);
#endif
  if constexpr (std::is_same_v<O, float>) {
    if (a.pool_ell != nullptr) {
      const long long groups = static_cast<long long>(a.p) * a.GP;
      const bool split = a.chunks > 1;
      grid.sync();
      CGR_STAMP(1, 6);
      items(static_cast<int>(groups * a.chunks), [&](int it) {
        pool_part_item<kBf16>(a.epi.out, a.epi.rows_per_pack, a.H,
                              a.pool_ell, a.GP, a.DN, a.chunks, it,
                              split ? a.part : a.pool,
                              split ? a.used : nullptr, pool_rows, &pool_n);
      });
      if (split) {
        grid.sync();
        CGR_STAMP(1, 7);
        items(chunks_of(groups * a.H), [&](int j) {
          pool_sum_item(a.part, a.used, groups, a.chunks, a.H, a.pool, j);
        });
      }
    }
  }
#ifdef CGR_PHASE_CLOCK
  grid.sync();
  CGR_STAMP(1, 9);
#endif
}

// --------------------------------------------------------------- backward

template <bool kBf16, class O, class DT>
struct BwdArgs {
  using E = Elem<kBf16>;
  GatherArgs<E, E> t1;     // t1 recomputed at stride t1.ldo, with rscale
  const E* xb;
  E* xbp;
  const float *wa, *wb, *b;
  E *wa16, *wb16;
  const O* out;
  Cotangent<kBf16, O> cot;
  int act;
  float* dpre;             // [rows, H]
  E* dpre16;               // bf16: dpre rounded
  DT* dt;                  // [rows, FA] (null: no dt, no dxa)
  E* dxb;
  float *dwa, *dwb, *db;
  float* wpart;            // [S, FA + FB + 1, H] split-K partials
  GatherArgs<DT, E> dxa;   // the adjoint gather of dt (dxa.out null: none)
  int p, FA, FB, H, S;
};

template <bool kBf16, int BMt, class O, class DT>
__global__ void __launch_bounds__(kThreads, 2) glin_bwd_kernel(const BwdArgs<kBf16, O, DT> a) {
  using E = Elem<kBf16>;
  extern __shared__ __align__(16) char smem[];
  CGR_STAMP(0, -1);
  const cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int rows = static_cast<int>(a.t1.rows), per = rows_per_item(a.p);
  const int FA = a.FA, FB = a.FB, H = a.H;
  const int FAp = static_cast<int>(a.t1.ld_out()), FBp = padded(FB);
  const long long na = static_cast<long long>(FA) * H,
                  nb = static_cast<long long>(FB) * H, nd = a.t1.rows * H;
  const bool relu = a.act == kRelu;
  const int n1[5] = {row_items(rows, per),
                     a.xbp != nullptr ? row_items(rows, per) : 0,
                     kBf16 ? chunks_of(na) : 0, kBf16 ? chunks_of(nb) : 0,
                     relu ? static_cast<int>((nd + kDpreChunk - 1) / kDpreChunk)
                          : 0};
  phase_items(n1, [&](int k, int j) {
    if (k == 0) {
      gather_item<kBf16>(a.t1, j, per);
      pad_item(a.t1.out, FA, FAp, rows, j, per);
    } else if (k == 1) {
      copy_item(a.xb, a.xbp, FB, FBp, rows, j, per);
    } else if (k == 4) {
      relu_dpre_item<kBf16>(a.out, a.cot, nd, a.dpre,
                            bf16_only<kBf16>(a.dpre16), j);
    } else if constexpr (kBf16) {
      if (k == 2)
        round_item(a.wa, a.wa16, na, j);
      else
        round_item(a.wb, a.wb16, nb, j);
    }
  });
  grid.sync();
  CGR_STAMP(1, 1);
  const bool copied = a.xbp != nullptr;
  const E* xb = copied ? a.xbp : a.xb;
  const int ldxb = copied ? FBp : FB;
  const E* wa = weights<kBf16>(a.wa, a.wa16);
  const E* wb = weights<kBf16>(a.wb, a.wb16);
  if (!relu) {
    const TilePairs<E, 2> pairs{{{a.t1.out, FAp, wa, H, FA, true},
                                 {xb, ldxb, wb, H, FB, copied}}};
    const DpreEpi<kBf16, O> epi{a.b, a.cot, a.act, a.dpre,
                                bf16_only<kBf16>(a.dpre16)};
    items(conv_tiles<BMt>(rows, H), [&](int it) {
      conv_tile_pairs<kBf16, BMt, false, false>(pairs, rows, H, it, epi,
                                                smem);
    });
    grid.sync();
    CGR_STAMP(1, 2);
  }
  // dxb's and dt's tiles, dWa's and dWb's split-K partial tiles, db's
  // column partials
  const E* dp = weights<kBf16>(a.dpre, a.dpre16);  // dpre as operand
  const long long chunk = (a.t1.rows + a.S - 1) / a.S;
  const int ta = conv_tiles<BMt>(FA, H), tb = conv_tiles<BMt>(FB, H),
            cb = (H + 255) / 256;
  float* part_a = a.wpart;
  float* part_b = part_a + static_cast<size_t>(a.S) * FA * H;
  float* cpart = part_b + static_cast<size_t>(a.S) * FB * H;
  const int n3[5] = {a.dxb != nullptr ? conv_tiles<BMt>(rows, FB) : 0,
                     a.dt != nullptr ? conv_tiles<BMt>(rows, FA) : 0,
                     a.dwa != nullptr ? a.S * ta : 0,
                     a.dwb != nullptr ? a.S * tb : 0,
                     a.db != nullptr ? a.S * cb : 0};
  phase_items(n3, [&](int k, int j) {
    if (k == 0) {
      conv_tile<kBf16, BMt, false, true>(dp, H, wb, H, rows, FB, H, j,
                                         StoreAs<E>{a.dxb, FB}, smem);
    } else if (k == 1) {
      conv_tile<kBf16, BMt, false, true>(dp, H, wa, H, rows, FA, H, j,
                                         StoreAs<DT>{a.dt, FA}, smem);
    } else if (k <= 3) {
      const bool first = k == 2;
      const int s = j / (first ? ta : tb);
      const long long k0 = s * chunk, left = a.t1.rows - k0;
      const int kn = static_cast<int>(left < chunk ? (left > 0 ? left : 0)
                                                    : chunk);
      const TilePairs<E, 1> pair{
          {{first ? a.t1.out + k0 * FAp : xb + k0 * ldxb, first ? FAp : ldxb,
            dp + k0 * H, H, kn, first || copied}}};
      const int M = first ? FA : FB;
      conv_tile_pairs<kBf16, BMt, true, false>(
          pair, M, H, j % (first ? ta : tb),
          StoreEpi{(first ? part_a : part_b) + static_cast<size_t>(s) * M * H,
                   H},
          smem);
    } else {
      const int s = j / cb, c = (j % cb) * 256 + threadIdx.x;
      if (c < H) {
        const long long k0 = s * chunk;
        const long long k1 = k0 + chunk < a.t1.rows ? k0 + chunk : a.t1.rows;
        float v = 0.f;
        for (long long r = k0; r < k1; ++r) v += a.dpre[r * H + c];
        cpart[static_cast<size_t>(s) * H + c] = v;
      }
    }
  });
  grid.sync();
  CGR_STAMP(1, 5);
  // the ordered sums and the adjoint gather
  const int n4[4] = {
      a.dwa != nullptr ? chunks_of(na) : 0,
      a.dwb != nullptr ? chunks_of(nb) : 0, a.db != nullptr ? chunks_of(H) : 0,
      a.dxa.out != nullptr ? row_items(static_cast<int>(a.dxa.rows), per) : 0};
  phase_items(n4, [&](int k, int j) {
    if (k == 0)
      sum_item(part_a, a.S, na, a.dwa, j);
    else if (k == 1)
      sum_item(part_b, a.S, nb, a.dwb, j);
    else if (k == 2)
      sum_item(cpart, a.S, H, a.db, j);
    else
      gather_item<kBf16>(a.dxa, j, per);
  });
#ifdef CGR_PHASE_CLOCK
  grid.sync();
  CGR_STAMP(1, 9);
#endif
}

// ------------------------------------------------------------------ host

struct Dims {
  int p, R, ca, FA, FB, H, D, act, mean;
  long long rows() const { return static_cast<long long>(p) * R; }
};

// A direction's scratch, carved out of one allocation (null base: only
// the bytes are counted).  Forward: t1 [rows, padded(FA)], xb's copy
// [rows, padded(FB)] (when xb_copied), at bf16 Wa and Wb rounded; K11 with
// more than one chunk the pool's partials [p·GP·chunks, H] and their used
// flags.  Backward: t1, xb's copy, dt [rows, FA] (DT), dpre [rows, H],
// rscale [rows], at bf16 Wa, Wb and dpre rounded, and the split-K
// partials [S, FA + FB + 1, H].
template <bool kBf16, class DT = Elem<kBf16>>
struct Scratch {
  using E = Elem<kBf16>;
  E *t1 = nullptr, *xbp = nullptr, *wa16 = nullptr, *wb16 = nullptr,
    *dpre16 = nullptr;
  DT* dt = nullptr;
  float *dpre = nullptr, *rscale = nullptr, *wpart = nullptr, *part = nullptr;
  int* used = nullptr;
  size_t bytes = 0;

  Scratch(void* base, const Dims& d, bool backward, int S, long long pool_items) {
    Carve c{static_cast<char*>(base)};
    const long long rows = d.rows();
    t1 = c.take<E>(rows * padded(d.FA));
    if (xb_copied(d.FB)) xbp = c.take<E>(rows * padded(d.FB));
    if (kBf16) {
      wa16 = c.take<E>(static_cast<long long>(d.FA) * d.H);
      wb16 = c.take<E>(static_cast<long long>(d.FB) * d.H);
    }
    if (!backward) {
      if (pool_items > 0) {
        part = c.take<float>(pool_items * d.H);
        used = c.take<int>(pool_items);
      }
    } else {
      dt = c.take<DT>(rows * d.FA);
      dpre = c.take<float>(rows * d.H);
      rscale = c.take<float>(rows);
      if (kBf16) dpre16 = c.take<E>(rows * d.H);
      wpart = c.take<float>(static_cast<long long>(S) * (d.FA + d.FB + 1) * d.H);
    }
    bytes = c.used;
  }
};

// K11's pool partials: p·GP·chunks items when chunks > 1.
long long pool_items(int p, int GP, int chunks) {
  return chunks > 1 ? static_cast<long long>(p) * GP * chunks : 0;
}

size_t scratch_bytes(const Dims& d, bool backward, int S, long long items,
                     int mat) {
  // dt counted at f32, the wider of its types (a bf16 dt carves fewer)
  return mat ? Scratch<true, float>(nullptr, d, backward, S, items).bytes
             : Scratch<false, float>(nullptr, d, backward, S, items).bytes;
}

template <bool kBf16>
GatherArgs<Elem<kBf16>, Elem<kBf16>> t1_args(const void* xa, const float* xr,
                                             const int* idx, const Dims& d,
                                             Elem<kBf16>* t1, float* rscale) {
  using E = Elem<kBf16>;
  GatherArgs<E, E> g{static_cast<const E*>(xa), d.ca, d.FA, idx, d.D,
                     nullptr, nullptr, d.mean, d.R, d.rows(), t1, rscale,
                     nullptr, xr, nullptr, 0, 1};
  g.ldo = padded(d.FA);
  return g;
}

// The kernel instantiations for 32- and 64-row tiles.
template <bool kBf16, class O>
const void* fwd_fn(int bm) {
  return bm == 32 ? reinterpret_cast<const void*>(&glin_fwd_kernel<kBf16, 32, O>)
                  : reinterpret_cast<const void*>(&glin_fwd_kernel<kBf16, 64, O>);
}

template <bool kBf16, class O, class DT>
const void* bwd_fn(int bm) {
  return bm == 32
             ? reinterpret_cast<const void*>(&glin_bwd_kernel<kBf16, 32, O, DT>)
             : reinterpret_cast<const void*>(&glin_bwd_kernel<kBf16, 64, O, DT>);
}

// The widest product of a direction: the rule's N (conv_grid.cuh).
int widest(const Dims& d, bool backward) {
  if (!backward) return d.H;
  const int n = d.FA > d.FB ? d.FA : d.FB;
  return n > d.H ? n : d.H;
}

// out [p·R, H] of type O (and K11's pool); one cooperative launch.
template <bool kBf16, class O>
int forward(const void* xa, const float* xr, const void* xb, const int* idx,
            const int* pool_ell, const float* wa, const float* wb,
            const float* b, void* scratch, void* out, float* pool,
            const Dims& d, int GP, int DN, int chunks, cudaStream_t st) {
  using E = Elem<kBf16>;
  if (d.rows() == 0) return 0;
  const long long items = pool_ell != nullptr ? pool_items(d.p, GP, chunks) : 0;
  const Scratch<kBf16> s(scratch, d, false, 0, items);
  FwdArgs<kBf16, O> a{};
  a.t1 = t1_args<kBf16>(xa, xr, idx, d, s.t1, nullptr);
  a.xb = static_cast<const E*>(xb);
  a.xbp = s.xbp;
  a.wa = wa;
  a.wb = wb;
  a.wa16 = s.wa16;
  a.wb16 = s.wb16;
  a.epi = LayerEpi<O>{b, nullptr, nullptr, d.act, nullptr, static_cast<O*>(out),
                      d.H, nullptr, 0, 0, d.R};
  a.pool_ell = pool_ell;
  a.pool = pool;
  a.part = s.part;
  a.used = s.used;
  a.GP = GP;
  a.DN = DN;
  a.chunks = chunks;
  a.p = d.p;
  a.FA = d.FA;
  a.FB = d.FB;
  a.H = d.H;
  return launch_conv(fwd_fn<kBf16, O>(32), fwd_fn<kBf16, O>(64), d.rows(),
                     widest(d, false), a, st);
}

// The cotangents (a null output is skipped); dt, when dxr is null, in the
// scratch.  g (and out) of type O; one cooperative launch.
template <bool kBf16, class O, class DT>
int backward(const void* xa, const float* xr, const void* xb, const int* idx,
             const int* adj, const int* node_group, const float* wa,
             const float* wb, const float* b, const void* out, const void* g,
             const float* gpool, void* dxa, DT* dxr, void* dxb, float* dwa,
             float* dwb, float* db, void* scratch, const Dims& d, int Dadj,
             int GP, int S, cudaStream_t st) {
  using E = Elem<kBf16>;
  if (d.rows() == 0) return 0;
  const Scratch<kBf16, DT> s(scratch, d, true, S, 0);
  BwdArgs<kBf16, O, DT> a{};
  a.t1 = t1_args<kBf16>(xa, xr, idx, d, s.t1, s.rscale);
  a.xb = static_cast<const E*>(xb);
  a.xbp = s.xbp;
  a.wa = wa;
  a.wb = wb;
  a.b = b;
  a.wa16 = s.wa16;
  a.wb16 = s.wb16;
  a.out = static_cast<const O*>(out);
  a.cot = Cotangent<kBf16, O>{static_cast<const O*>(g), gpool, node_group,
                              d.R, GP, d.H};
  a.act = d.act;
  a.dpre = s.dpre;
  a.dpre16 = s.dpre16;
  a.dt = dxr != nullptr ? dxr : (dxa != nullptr ? s.dt : nullptr);
  a.dxb = static_cast<E*>(dxb);
  a.dwa = dwa;
  a.dwb = dwb;
  a.db = db;
  a.wpart = s.wpart;
  a.dxa = GatherArgs<DT, E>{a.dt, d.R, d.FA, adj, Dadj, nullptr,
                            d.mean ? s.rscale : nullptr, 0, d.ca,
                            static_cast<long long>(d.p) * d.ca,
                            dxa != nullptr ? static_cast<E*>(dxa) : nullptr,
                            nullptr};
  a.p = d.p;
  a.FA = d.FA;
  a.FB = d.FB;
  a.H = d.H;
  a.S = S;
  return launch_conv(bwd_fn<kBf16, O, DT>(32), bwd_fn<kBf16, O, DT>(64),
                     d.rows(), widest(d, true), a, st);
}

// A launch's own error code, or the runtime's last one.
int status(int err) {
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace

// The cooperative grid of a launch over p·R rows (forward: its width H;
// backward: the widest of FA, FB and H) at mat 0 (f32) or 1 (bf16), on
// the current device: returns the blocks (or minus a CUDA error code) and
// writes the tile rows, the blocks per SM and the SMs.
extern "C" int cgr_gather_linear_grid(int p, int R, int FA, int FB, int H,
                                      int mat, int backward, int* bm,
                                      int* per_sm, int* sms) {
  using B = Elem<true>;
  const Dims d{p, R, 0, FA, FB, H, 0, 0, 0};
  const void *fn32, *fn64, *fn = nullptr;
  if (backward) {
    fn32 = mat ? bwd_fn<true, float, B>(32) : bwd_fn<false, float, float>(32);
    fn64 = mat ? bwd_fn<true, float, B>(64) : bwd_fn<false, float, float>(64);
  } else {
    fn32 = mat ? fwd_fn<true, float>(32) : fwd_fn<false, float>(32);
    fn64 = mat ? fwd_fn<true, float>(64) : fwd_fn<false, float>(64);
  }
  int grid = 0;
  const int err = conv_grid_of(fn32, fn64, d.rows(), widest(d, backward != 0),
                               &fn, bm, &grid, per_sm, sms);
  return err != 0 ? -err : grid;
}

// Bytes of a forward's scratch (K5's: GP = 0; K10/K11's with their pool's
// GP groups a pack in `chunks` chunks) and of a backward's (S split-K
// partials), at mat 0 or 1.
extern "C" long long cgr_gather_linear_fwd_scratch_bytes(int p, int R, int FA,
                                                         int FB, int H, int GP,
                                                         int chunks, int mat) {
  const Dims d{p, R, 0, FA, FB, H, 0, 0, 0};
  return static_cast<long long>(
      scratch_bytes(d, false, 0, pool_items(p, GP, chunks), mat));
}

extern "C" long long cgr_gather_linear_bwd_scratch_bytes(int p, int R, int FA,
                                                         int FB, int H, int S,
                                                         int mat) {
  const Dims d{p, R, 0, FA, FB, H, 0, 0, 0};
  return static_cast<long long>(scratch_bytes(d, true, S, 0, mat));
}

// out [p·R, H]; scratch of cgr_gather_linear_fwd_scratch_bytes.  xa and xb
// are f32, or bf16 with mat = 1; out is bf16 when out_bf16 (mat = 1 only),
// else f32.  One cooperative launch.
extern "C" int cgr_gather_linear_fwd(const void* xa, const void* xb,
                                     const int* idx, const float* wa,
                                     const float* wb, const float* b,
                                     void* scratch, void* out, int p, int R,
                                     int ca, int FA, int FB, int H, int D,
                                     int act, int mean, int mat, int out_bf16,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{p, R, ca, FA, FB, H, D, act, mean};
  if (!mat)
    return status(forward<false, float>(xa, nullptr, xb, idx, nullptr, wa, wb,
                                        b, scratch, out, nullptr, d, 0, 0, 1,
                                        st));
  if (out_bf16)
    return status(forward<true, __nv_bfloat16>(xa, nullptr, xb, idx, nullptr,
                                               wa, wb, b, scratch, out,
                                               nullptr, d, 0, 0, 1, st));
  return status(forward<true, float>(xa, nullptr, xb, idx, nullptr, wa, wb, b,
                                     scratch, out, nullptr, d, 0, 0, 1, st));
}

// Cotangents from g [p·R, H] (the forward's output `out` given; both of
// out's type): dxa [p·ca, FA] through adj [p·ca, Dadj] and dxb [p·R, FB]
// of xa's type, dwa [FA, H], dwb [FB, H], db [H]; a null output is
// skipped.  scratch of cgr_gather_linear_bwd_scratch_bytes (S split-K
// partials).  One cooperative launch.
extern "C" int cgr_gather_linear_bwd(
    const void* xa, const void* xb, const int* idx, const int* adj,
    const float* wa, const float* wb, const float* b, const void* out,
    const void* g, void* dxa, void* dxb, float* dwa, float* dwb, float* db,
    void* scratch, int p, int R, int ca, int FA, int FB, int H, int D,
    int Dadj, int act, int mean, int S, int mat, int out_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{p, R, ca, FA, FB, H, D, act, mean};
  using B = __nv_bfloat16;
  if (!mat)
    return status(backward<false, float, float>(
        xa, nullptr, xb, idx, adj, nullptr, wa, wb, b, out, g, nullptr, dxa,
        nullptr, dxb, dwa, dwb, db, scratch, d, Dadj, 0, S, st));
  if (out_bf16)
    return status(backward<true, B, B>(xa, nullptr, xb, idx, adj, nullptr, wa,
                                       wb, b, out, g, nullptr, dxa, nullptr,
                                       dxb, dwa, dwb, db, scratch, d, Dadj, 0,
                                       S, st));
  return status(backward<true, float, B>(xa, nullptr, xb, idx, adj, nullptr,
                                         wa, wb, b, out, g, nullptr, dxa,
                                         nullptr, dxb, dwa, dwb, db, scratch,
                                         d, Dadj, 0, S, st));
}

// The EP readout (K10; K11 when pool_ell is set): out [p·R, H] and, with
// the pool, pool [p·GP, H] through pool_ell [p·GP, DN] (node slots of each
// group, sentinel-padded), split into `chunks` = max(1, ceil(DN /
// kPoolChunk)) chunks (another count is refused); scratch of
// cgr_gather_linear_fwd_scratch_bytes.  xa and xb are f32, or bf16 with
// mat = 1; xr, out and the pool are f32.  One cooperative launch.
extern "C" int cgr_gather_linear_r_fwd(const void* xa, const float* xr,
                                       const void* xb, const int* idx,
                                       const int* pool_ell, const float* wa,
                                       const float* wb, const float* b,
                                       void* scratch, float* out, float* pool,
                                       int p, int R, int ca, int FA, int FB,
                                       int H, int D, int GP, int DN,
                                       int chunks, int act, int mean, int mat,
                                       void* stream) {
  if (pool_ell != nullptr &&
      chunks != (DN > kPoolChunk ? (DN + kPoolChunk - 1) / kPoolChunk : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{p, R, ca, FA, FB, H, D, act, mean};
  return status((mat ? forward<true, float> : forward<false, float>)(
      xa, xr, xb, idx, pool_ell, wa, wb, b, scratch, out, pool, d, GP, DN,
      chunks, st));
}

// Cotangents of the EP readout from g [p·R, H] (and, for K11, gpool
// [p·GP, H] through node_group [p·R]): dxa, dxr, dxb, dwa, dwb, db as
// K5's with dxr = dpre·Waᵀ; a null output is skipped.  dxa and dxb take
// xa's type, the rest is f32.  scratch of
// cgr_gather_linear_bwd_scratch_bytes.  One cooperative launch.
extern "C" int cgr_gather_linear_r_bwd(
    const void* xa, const float* xr, const void* xb, const int* idx,
    const int* adj, const int* node_group, const float* wa, const float* wb,
    const float* b, const float* out, const float* g, const float* gpool,
    void* dxa, float* dxr, void* dxb, float* dwa, float* dwb, float* db,
    void* scratch, int p, int R, int ca, int FA, int FB, int H, int D,
    int Dadj, int GP, int act, int mean, int S, int mat, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{p, R, ca, FA, FB, H, D, act, mean};
  return status((mat ? backward<true, float, float>
                     : backward<false, float, float>)(
      xa, xr, xb, idx, adj, node_group, wa, wb, b, out, g, gpool, dxa, dxr,
      dxb, dwa, dwb, db, scratch, d, Dadj, GP, S, st));
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
