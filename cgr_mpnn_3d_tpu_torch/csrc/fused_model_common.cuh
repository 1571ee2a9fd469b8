// Device code shared by the whole-model kernels (fused_model_fwd.cu and
// fused_model_bwd.cu): the elementwise helpers of the TPU kernels
// (cgr_mpnn_3d_tpu/ops/pallas_fused.py: k_act, k_dact, mean_colscale,
// _hash_bits / k_dropout_mask), a shared-memory-tiled product with plain or
// transposed operands, the ELL gather sums, and the forward's steps
// (pallas_model.py::_replay_forward) as items that both kernels run.
//
// Everything that touches a product's operands is templated on kBf16, the
// TPU kernels' mat_dtype: false is the f32 FMA product; true rounds every
// operand of a product, of a gather-sum and of the head to bf16 (round to
// nearest even) as it is read, runs the products on the tensor cores
// (mma.sync m16n8k16, f32 sums) and scales a mean by bf16(1 / degree).
// Elementwise work (biases, skip·h0, activations, dropout) and every stored
// state stay f32 in both.
//
// The work is cut into items that one thread block of kThreads threads
// computes: one 64 x 64 output tile of a product, or a range of rows of an
// elementwise or gather pass, of one pack.  Both kernels spread the items
// of every pack over the whole grid, one phase at a time
// (fused_model_grid.cuh).  Indices are global, with the sentinel equal to
// the row count; an index outside the item's own pack (the sentinel
// included) is skipped and never read through, which is what a
// never-matching one-hot column does on the TPU.
//
// Data written by one phase of a kernel and read by a later one (the
// states) is never read through __restrict__ pointers: those may load
// through the non-coherent read-only path.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "tensor_core.cuh"

namespace cgr {

constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int BM = 64, BN = 64, BK = 16;
constexpr int TM = 4, TN = 4;          // thread (ty, tx): rows ty + 16 i, cols tx + 16 j

// ops/kernel_math.CONV_ACTS; linear (the identity) only in fused_conv.cu
enum Act { kRelu = 0, kSilu = 1, kGelu = 2, kLinear = 3 };

// k_act: relu, silu (x * sigmoid(x)), exact-erf gelu or linear.
__device__ __forceinline__ float k_act(int act, float x) {
  if (act == kRelu) return fmaxf(x, 0.f);
  if (act == kLinear) return x;
  if (act == kSilu) return x / (1.f + expf(-x));
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// Whether a backward needs the pre-activation: ReLU reads the saved output
// instead, and linear's derivative is 1 (pallas_fused.py:280-290).
__host__ __device__ __forceinline__ bool needs_pre(int act) {
  return act == kSilu || act == kGelu;
}

// k_dact: d act(x) / dx.
__device__ __forceinline__ float k_dact(int act, float x) {
  if (act == kRelu) return x > 0.f ? 1.f : 0.f;
  if (act == kLinear) return 1.f;
  if (act == kSilu) {
    const float s = 1.f / (1.f + expf(-x));
    return s * (1.f + x * (1.f - s));
  }
  const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
  return cdf + x * (0.3989422804014327f * expf(-0.5f * x * x));
}

// mean_colscale: 1 / degree, where a row with no entries divides by 1; an
// entry of the bf16 one-hot matrix when kBf16.
template <bool kBf16 = false>
__device__ __forceinline__ float mean_colscale(int count) {
  const float s = 1.f / fmaxf(static_cast<float>(count), 1.f);
  return kBf16 ? round_bf16(s) : s;
}

// v as an operand of a product or a gather-sum.
template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  return kBf16 ? round_bf16(v) : v;
}

// _hash_bits: murmur3 finalizer over (pack-local row, column, seed, pack),
// uint32 arithmetic with wraparound.
__device__ __forceinline__ unsigned hash_bits(unsigned row, unsigned col,
                                              unsigned seed, unsigned pack) {
  unsigned x = row * 65537u + col + seed * 0x9E3779B9u + pack * 0x85EBCA6Bu;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The hash dropout of one conv layer: keep where bits >= thr, and scale
// the kept values by 1 / (1 - rate).  `on` is 0 in eval mode.
struct Dropout {
  int on;
  unsigned seed, thr, pack;
  float scale;
  __device__ __forceinline__ bool kept(int row, int col) const {
    return hash_bits(static_cast<unsigned>(row), static_cast<unsigned>(col),
                     seed, pack) >= thr;
  }
  __device__ __forceinline__ float apply(int row, int col, float v) const {
    if (!on) return v;
    return kept(row, col) ? v * scale : 0.f;
  }
};

// `drop` is the wrapper's [3, L] table (seeds, thresholds as uint32 bits,
// scales as f32 bits), or nullptr in eval mode; `pack` is the pack index.
__device__ __forceinline__ Dropout layer_dropout(const int* drop, int L,
                                                 int l, int pack) {
  if (drop == nullptr) return Dropout{0, 0u, 0u, 0u, 1.f};
  return Dropout{1, static_cast<unsigned>(drop[l]),
                 static_cast<unsigned>(drop[L + l]),
                 static_cast<unsigned>(pack), __int_as_float(drop[2 * L + l])};
}

// Rows of a dense operand [*, K] of element type T (f32, or bf16 in the
// layered kernels' bf16 instantiation): row m is base + m*K, or with `ids`
// the row ids[m] - lo when that lies in [0, n), and a zero row otherwise.
template <class T>
struct RowsOf {
  const T* base;
  int K;
  const int* ids;
  int lo, n;
  __device__ __forceinline__ const T* row(int m) const {
    if (ids == nullptr) return base + static_cast<size_t>(m) * K;
    const int r = ids[m] - lo;
    return (r >= 0 && r < n) ? base + static_cast<size_t>(r) * K : nullptr;
  }
};
using Rows = RowsOf<float>;

struct Smem {
  float a[BK][BM + 1];  // +1 keeps the k-major stores conflict-free
  float b[BK][BN + 1];
};

// The bf16 tiles: A as [m][k] and B as [n][k] (k contiguous, the layout
// the mma fragments read two values at a time), BK16 deep; a row of
// BK16 + 8 bf16 (20 words) puts the eight rows of a fragment load in
// eight different bank quads.
constexpr int BK16 = 32;
struct SmemBf16 {
  alignas(16) unsigned short a[BM][BK16 + 8];
  alignas(16) unsigned short b[BN][BK16 + 8];
};

template <bool kBf16>
using SmemOf = std::conditional_t<kBf16, SmemBf16, Smem>;

// acc += Aop[m0:m0+BM, 0:K] · Bop[0:K, n0:n0+BN], where
//   Aop(m, k) = A.row(m)[k]  (TA false)  or  A.row(k)[m]  (TA true: Aᵀ),
//   Bop(k, n) = B[k*ldb + n] (TB false)  or  B[n*ldb + k] (TB true: Bᵀ).
template <bool TA, bool TB>
__device__ __forceinline__ void mma_tile(float (&acc)[TM][TN], const Rows& A,
                                         const float* B, int ldb,
                                         int K, int m0, int n0, int M, int N,
                                         Smem& sm) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      // neighbouring threads read neighbouring addresses of A
      const int mm = TA ? i % BM : i / BK, kk = TA ? i / BM : i % BK;
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K) {
        const float* r = A.row(TA ? k : m);
        if (r != nullptr) v = r[TA ? m : k];
      }
      sm.a[kk][mm] = v;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int nn = TB ? i / BK : i % BN, kk = TB ? i % BK : i / BN;
      const int k = k0 + kk, n = n0 + nn;
      float v = 0.f;
      if (k < K && n < N)
        v = B[TB ? static_cast<size_t>(n) * ldb + k
                 : static_cast<size_t>(k) * ldb + n];
      sm.b[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = sm.a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = sm.b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The tensor-core twin of mma_tile, operands rounded to bf16 as they are
// staged (A's elements f32 or bf16): warp w accumulates rows 16 (w % 4)
// .. + 16 and columns 32 (w / 4) .. + 32 of the tile, as four 16 x 8 mma
// tiles; acc[j] holds tile j's fragment (rows g, g + 8; columns
// 8 j + 2 t, + 1).
template <bool TA, bool TB, class T>
__device__ __forceinline__ void mma_tile_bf16(float (&acc)[4][4],
                                              const RowsOf<T>& A,
                                              const float* B,
                                              int ldb, int K, int m0, int n0,
                                              int M, int N, SmemBf16& sm) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = 16 * (warp % 4), wc = 32 * (warp / 4);
  for (int k0 = 0; k0 < K; k0 += BK16) {
    for (int i = tid; i < BM * BK16; i += kThreads) {
      // neighbouring threads read neighbouring addresses of A
      const int mm = TA ? i % BM : i / BK16, kk = TA ? i / BM : i % BK16;
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K) {
        const T* r = A.row(TA ? k : m);
        if (r != nullptr) v = to_f32(r[TA ? m : k]);
      }
      sm.a[mm][kk] = bf16_bits(v);
    }
    for (int i = tid; i < BK16 * BN; i += kThreads) {
      const int nn = TB ? i / BK16 : i % BN, kk = TB ? i % BK16 : i / BN;
      const int k = k0 + kk, n = n0 + nn;
      float v = 0.f;
      if (k < K && n < N)
        v = B[TB ? static_cast<size_t>(n) * ldb + k
                 : static_cast<size_t>(k) * ldb + n];
      sm.b[nn][kk] = bf16_bits(v);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK16; ks += 16) {
      const unsigned a[4] = {ld_b32(&sm.a[wr + g][ks + 2 * t]),
                             ld_b32(&sm.a[wr + g + 8][ks + 2 * t]),
                             ld_b32(&sm.a[wr + g][ks + 8 + 2 * t]),
                             ld_b32(&sm.a[wr + g + 8][ks + 8 + 2 * t])};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wc + 8 * j + g;
        const unsigned b[2] = {ld_b32(&sm.b[n][ks + 2 * t]),
                               ld_b32(&sm.b[n][ks + 8 + 2 * t])};
        mma_bf16_16816(acc[j], a, b);
      }
    }
    __syncthreads();
  }
}

// One operand pair of a product: Aop · Bop with reduction length K.
template <class T>
struct OperandsOf {
  RowsOf<T> A;
  const float* B;
  int ldb, K;
};
using Operands = OperandsOf<float>;

// The 64 x 64 output tiles of an M x N product.
__host__ __device__ __forceinline__ int tiles_of(int M, int N) {
  return ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
}

// epi(m, n, Σ over the pairs of Aop·Bop [m, n]) over tile `tile` (tiles
// in row-major order) of an M x N output.
template <bool kBf16, bool TA, bool TB, class Epi>
__device__ void gemm_tile(const Operands& p1, const Operands* p2, int M,
                          int N, int tile, const Epi& epi,
                          SmemOf<kBf16>& sm) {
  const int tid = threadIdx.x, tiles_n = (N + BN - 1) / BN;
  const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
  float acc[TM][TN] = {};
  if constexpr (kBf16) {
    mma_tile_bf16<TA, TB>(acc, p1.A, p1.B, p1.ldb, p1.K, m0, n0, M, N, sm);
    if (p2 != nullptr)
      mma_tile_bf16<TA, TB>(acc, p2->A, p2->B, p2->ldb, p2->K, m0, n0, M, N,
                            sm);
    const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + 16 * (warp % 4) + g + 8 * (q / 2);
        const int n = n0 + 32 * (warp / 4) + 8 * j + 2 * t + q % 2;
        if (m < M && n < N) epi(m, n, acc[j][q]);
      }
  } else {
    const int tx = tid % 16, ty = tid / 16;
    mma_tile<TA, TB>(acc, p1.A, p1.B, p1.ldb, p1.K, m0, n0, M, N, sm);
    if (p2 != nullptr)
      mma_tile<TA, TB>(acc, p2->A, p2->B, p2->ldb, p2->K, m0, n0, M, N, sm);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx + 16 * j;
        if (m < M && n < N) epi(m, n, acc[i][j]);
      }
    }
  }
}

// out = drop(act(acc + bias [+ skip·h0])), rows of width ld; the
// pre-activation is stored too when `pre` is set.
struct ActEpi {
  const float* bias;   // [N]
  const float* h0;     // added times `skip`; nullptr for none
  float skip;
  int act;
  float* pre;          // nullptr: not stored
  float* out;
  int ld;
  Dropout drop;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    const size_t o = static_cast<size_t>(m) * ld + n;
    float v = acc + bias[n];
    if (h0 != nullptr) v = fmaf(skip, h0[o], v);
    if (pre != nullptr) pre[o] = v;
    out[o] = drop.apply(m, n, k_act(act, v));
  }
};

// out[m, n] = acc.
struct StoreEpi {
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    out[static_cast<size_t>(m) * ld + n] = acc;
  }
};

// out[r, :] = scale_r · Σ_d src[ids[r, d] - lo, :]  [- src[rev[r] - lo, :]]
// over the rows r0 <= r < r1 of width H; entries outside [0, n) are
// skipped, and scale_r = mean_colscale(entries counted) when `mean`, else
// 1.  The rev row is unscaled (its one-hot entry is -1, exact in bf16 too).
template <bool kBf16>
__device__ void gather_sum(const float* src, int n, int lo,
                           const int* __restrict__ ids, int D,
                           const int* __restrict__ rev, bool mean, int r0,
                           int r1, int H, float* out) {
  for (int i = threadIdx.x; i < (r1 - r0) * H; i += kThreads) {
    const int r = r0 + i / H, c = i % H;
    const int* row = ids + static_cast<size_t>(r) * D;
    float sum = 0.f;
    int count = 0;
    for (int d = 0; d < D; ++d) {
      const int j = row[d] - lo;
      if (j >= 0 && j < n) {
        sum += operand<kBf16>(src[static_cast<size_t>(j) * H + c]);
        ++count;
      }
    }
    if (mean) sum *= mean_colscale<kBf16>(count);
    if (rev != nullptr) {
      const int j = rev[r] - lo;
      if (j >= 0 && j < n)
        sum -= operand<kBf16>(src[static_cast<size_t>(j) * H + c]);
    }
    out[static_cast<size_t>(r) * H + c] = sum;
  }
}

// out[g] = pooled[g, :] · wffn + bffn for g0 <= g < g1, one warp per graph.
template <bool kBf16>
__device__ void head(const float* pooled, int g0, int g1, int H,
                     const float* __restrict__ wffn,
                     const float* __restrict__ bffn, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = g0 + warp; g < g1; g += kThreads / 32) {
    float v = 0.f;
    for (int c = lane; c < H; c += 32)
      v = fmaf(operand<kBf16>(pooled[static_cast<size_t>(g) * H + c]),
               operand<kBf16>(wffn[c]), v);
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) out[g] = v + bffn[0];
  }
}

// The model's inputs, as the wrappers in ops/fused_model.py pass them.
struct ModelArgs {
  const float *x, *e;
  const int *senders, *edge_nbr, *rev, *node_inc, *graph_nodes;
  const float *wx, *we, *be, *wc, *bc, *skips, *ws, *wxn, *ben, *wffn, *bffn;
  const int* drop;  // [3, L] dropout table, nullptr in eval mode
  int te, tn, tb, F, Fe, H, L, D, DN, act, mean_aggr, mean_pool;
};

// Where one pack's forward writes its states.  `t` and `pre` hold one
// layer each at stride t_stride / pre_stride (0: every layer overwrites
// the same rows); the pre-activations are stored only where the pointer
// is set.
struct FwdState {
  float *pre0, *h0, *t, *pre, *h, *s, *pre_n, *hn, *pooled, *preds;
  size_t t_stride, pre_stride;
};

// The forward of pack q (pallas_model.py::_replay_forward), as items:
//
//   h0     = act(x[senders]·Wx + e·We + be)                   edge_init
//   for l < L:
//     t    = scale·Σ_d h[edge_nbr[:, d]] − h[rev]             messages
//     h    = drop_l(act(t·Wc[l] + bc[l] + skip[l]·h0))        conv layer l
//   s      = scale·Σ_d h[node_inc[:, d]]                      readout sum
//   hn     = act(s·Ws + x·Wxn + ben)                          edge_to_node
//   pooled = scale·Σ_k hn[graph_nodes[:, k]]                  pooling
//   pred   = pooled·wffn + bffn                               ffn head
//
// "scale" is 1 for add and 1 / (number of counted entries) for mean; the
// rev term stays unscaled.  Each step's items depend only on the steps
// before it, so a kernel may run the items of one step in any blocks, in
// any order, once every item of the step before has finished.  A product
// has tiles_of(rows, H) items, one 64 x 64 output tile each; a gather,
// one per range of rows; pooling and the head, one per range of graphs.

template <bool kBf16>
__device__ void edge_init_tile(const ModelArgs& a, const FwdState& st,
                               int q, int tile, SmemOf<kBf16>& sm) {
  const int eb = q * a.te, nb = q * a.tn;
  const Operands xw{Rows{a.x + static_cast<size_t>(nb) * a.F, a.F,
                         a.senders + eb, nb, a.tn},
                    a.wx, a.H, a.F};
  const Operands ew{Rows{a.e + static_cast<size_t>(eb) * a.Fe, a.Fe, nullptr,
                         0, 0},
                    a.we, a.H, a.Fe};
  const Dropout none{0, 0u, 0u, 0u, 1.f};
  gemm_tile<kBf16, false, false>(
      xw, &ew, a.te, a.H, tile,
      ActEpi{a.be, nullptr, 0.f, a.act, st.pre0, st.h0, a.H, none}, sm);
}

// Messages of layer l over rows [r0, r1) from h_in (h0 when l is 0).
template <bool kBf16>
__device__ void message_rows(const ModelArgs& a, const FwdState& st, int q,
                             int l, int r0, int r1) {
  const int eb = q * a.te;
  gather_sum<kBf16>(l == 0 ? st.h0 : st.h, a.te, eb,
                    a.edge_nbr + static_cast<size_t>(eb) * a.D, a.D,
                    a.rev + eb, a.mean_aggr != 0, r0, r1, a.H,
                    st.t + l * st.t_stride);
}

template <bool kBf16>
__device__ void conv_tile(const ModelArgs& a, const FwdState& st, int q,
                          int l, int tile, SmemOf<kBf16>& sm) {
  const int H = a.H;
  const Operands tw{Rows{st.t + l * st.t_stride, H, nullptr, 0, 0},
                    a.wc + static_cast<size_t>(l) * H * H, H, H};
  gemm_tile<kBf16, false, false>(
      tw, nullptr, a.te, H, tile,
      ActEpi{a.bc + static_cast<size_t>(l) * H, st.h0, a.skips[l], a.act,
             st.pre == nullptr ? nullptr : st.pre + l * st.pre_stride, st.h,
             H, layer_dropout(a.drop, a.L, l, q)},
      sm);
}

// The readout's incoming sum s over node rows [r0, r1) from the last h.
template <bool kBf16>
__device__ void readout_rows(const ModelArgs& a, const FwdState& st, int q,
                             int r0, int r1) {
  const int eb = q * a.te, nb = q * a.tn;
  gather_sum<kBf16>(a.L == 0 ? st.h0 : st.h, a.te, eb,
                    a.node_inc + static_cast<size_t>(nb) * a.D, a.D, nullptr,
                    a.mean_aggr != 0, r0, r1, a.H, st.s);
}

template <bool kBf16>
__device__ void readout_tile(const ModelArgs& a, const FwdState& st, int q,
                             int tile, SmemOf<kBf16>& sm) {
  const int H = a.H, nb = q * a.tn;
  const Operands sw{Rows{st.s, H, nullptr, 0, 0}, a.ws, H, H};
  const Operands xn{Rows{a.x + static_cast<size_t>(nb) * a.F, a.F, nullptr,
                         0, 0},
                    a.wxn, H, a.F};
  const Dropout none{0, 0u, 0u, 0u, 1.f};
  gemm_tile<kBf16, false, false>(
      sw, &xn, a.tn, H, tile,
      ActEpi{a.ben, nullptr, 0.f, a.act, st.pre_n, st.hn, H, none}, sm);
}

// Pooled rows and predictions of the graphs [g0, g1) of pack q.
template <bool kBf16>
__device__ void pool_head(const ModelArgs& a, const FwdState& st, int q,
                          int g0, int g1) {
  const int nb = q * a.tn, gb = q * a.tb;
  gather_sum<kBf16>(st.hn, a.tn, nb,
                    a.graph_nodes + static_cast<size_t>(gb) * a.DN, a.DN,
                    nullptr, a.mean_pool != 0, g0, g1, a.H, st.pooled);
  __syncthreads();
  head<kBf16>(st.pooled, g0, g1, a.H, a.wffn, a.bffn, st.preds);
}

}  // namespace cgr
