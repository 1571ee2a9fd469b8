// Device code shared by the layered kernels (gather_linear.cu,
// conv_stack.cu, fused_conv.cu): the element of a pack-local ELL gather-sum
// over a whole batch (K7, onehot_spmm.cu, has a kernel of its own), an
// epilogue of a product's tiles, a fixed-order sum of partials, scratch
// carving, and a conv layer's dpre pass (the conv layer and the
// gather-linear themselves, forward and backward, are conv_grid.cuh's
// cooperative grid and its tile).
//
// Unlike the whole-model kernels, these run a grid over the whole batch:
// a block is not a pack.  A row's pack is its row index over the rows per
// pack, its sources lie in [pack·C, (pack + 1)·C), and the hash dropout
// takes that pack and the pack-local row explicitly (never blockIdx.x).
// Indices outside the window of their row's pack, the sentinel included,
// count as absent.  No float atomics: every sum runs in a fixed order, so
// reruns are bit-identical.
//
// Everything is templated on kBf16, the TPU kernels' mat_dtype (as in
// fused_model_common.cuh).  false: f32 operands, f32 FMA products (in
// mma_tile's order), every state f32.  true: every operand of a product
// and of a gather-sum rounded to bf16 as it is read, the products on the
// tensor cores (f32 sums), a mean scaled by bf16(1 / degree), and
// the states the TPU kernels store at out_dtype bf16 (h0, every layer's h,
// the messages t, their cotangents) held as __nv_bfloat16 (Elem<true>).
// Rounding a value where it is stored gives the numbers of rounding it
// where it enters a product, which is where the TPU kernels round.
// Pre-activations, dpre, weight gradients and every sum stay f32.

#pragma once

#include <type_traits>

#include "fused_model_common.cuh"

namespace cgr {

constexpr int kReduceBlocks = 264;  // blocks of a grid-stride reduction

// The element type of the stored states.
template <bool kBf16>
using Elem = std::conditional_t<kBf16, __nv_bfloat16, float>;

// out[r, :] = scale_r · (Σ_d w_j·src[j, :] + extra[k, :])  [− src[sign[r], :]],
// j = idx[r, d], over `rows` output rows of width W, R rows per pack, C
// source rows per pack.  w_j = src_scale[j] (1 when nullptr); scale_r =
// row_scale[r] when given, else mean_colscale(entries counted) when `mean`,
// else 1; the sign term stays unscaled.  The extra term (f32, when `extra`
// is set) is row k = extra_idx[r] of the window of extra_C rows of r's pack
// (absent outside it), or row r itself when extra_idx is nullptr; it is
// scaled by row_scale[r] only (a mean scale leaves it as it is, as the TPU
// kernels' S·r term), and rounded as an operand unless `extra_exact` (the
// EP readout adds its f32 xr unrounded).  Under kBf16 the scales are
// entries of the one-hot matrix, so w_j and row_scale[r] are rounded to
// bf16 too.  With `rscale`, scale_r is written there too.  src is S (f32
// or bf16), out O, its rows ldo apart (0: W, the source's row stride).
// Leaving the trailing members out of an initializer leaves them null.
template <class S, class O>
struct GatherArgs {
  const S* src;
  int C, W;
  const int* idx;
  int D;
  const int* sign;
  const float* src_scale;
  int mean, R;
  long long rows;
  O* out;
  float* rscale;
  const float* row_scale;
  const float* extra;
  const int* extra_idx;
  int extra_C;
  int extra_exact;
  int ldo;
  __host__ __device__ __forceinline__ long long ld_out() const {
    return ldo != 0 ? ldo : W;
  }
};

// Element (r, c) of the gather-sum, for any c (the entries are counted
// for c >= W too, and nothing is stored there); row r's scale goes to
// rscale when `scale_out` is set.
template <bool kBf16, class S, class O>
__device__ __forceinline__ void gather_elem(const GatherArgs<S, O>& a,
                                            long long r, int c,
                                            bool scale_out) {
  const long long lo = (r / a.R) * a.C;
  const int* row = a.idx + r * a.D;
  float sum = 0.f;
  int count = 0;
  for (int d = 0; d < a.D; ++d) {
    const long long j = row[d] - lo;
    if (j >= 0 && j < a.C) {
      ++count;
      if (c < a.W) {
        const float v = operand<kBf16>(to_f32(a.src[(lo + j) * a.W + c]));
        // one fused multiply-add per scaled entry, in every kernel that
        // inlines this (left to the compiler, the contraction differs
        // from kernel to kernel, and so would the bits)
        sum = a.src_scale == nullptr
                  ? sum + v
                  : fmaf(operand<kBf16>(a.src_scale[lo + j]), v, sum);
      }
    }
  }
  float scale = a.mean ? mean_colscale<kBf16>(count) : 1.f;
  if (a.row_scale != nullptr) scale = operand<kBf16>(a.row_scale[r]);
  if (a.mean || a.row_scale != nullptr) sum *= scale;
  if (a.extra != nullptr && c < a.W) {
    long long k = r;
    bool in = true;
    if (a.extra_idx != nullptr) {
      const long long elo = (r / a.R) * a.extra_C;
      k = a.extra_idx[r] - elo;
      in = k >= 0 && k < a.extra_C;
      k += elo;
    }
    if (in) {
      const float e = a.extra[k * a.W + c];
      const float v = a.extra_exact ? e : operand<kBf16>(e);
      // a product, then a sum: never contracted (see above)
      sum = a.row_scale == nullptr ? sum + v
                                   : __fadd_rn(sum, __fmul_rn(scale, v));
    }
  }
  if (a.sign != nullptr) {
    const long long j = a.sign[r] - lo;
    if (j >= 0 && j < a.C && c < a.W)
      sum -= operand<kBf16>(to_f32(a.src[(lo + j) * a.W + c]));
  }
  if (c < a.W) a.out[r * a.ld_out() + c] = from_f32<O>(sum);
  if (a.rscale != nullptr && scale_out) a.rscale[r] = scale;
}

// out = drop_l(act(acc + bias [+ skip·h0])) over rows of width ld, h0 of
// type T and out of type O; the f32 pre-activation is stored too when `pre` is set,
// the output only when `out` is.  `drop` is the wrapper's [3, L] table
// (seeds, thresholds, scales) or nullptr; row m is pack-local row
// m % rows_per_pack of pack m / rows_per_pack.
template <class T, class O = T>
struct LayerEpi {
  const float* bias;
  const T* h0;        // nullptr: no skip term
  const float* skip;  // the layer's skip weight (device)
  int act;
  float* pre;
  O* out;
  int ld;
  const int* drop;
  int L, l, rows_per_pack;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    const size_t o = static_cast<size_t>(m) * ld + n;
    float v = acc + bias[n];
    if (h0 != nullptr) v = fmaf(*skip, to_f32(h0[o]), v);
    if (pre != nullptr) pre[o] = v;
    if (out == nullptr) return;
    float y = k_act(act, v);
    if (drop != nullptr) {
      const Dropout d{1, static_cast<unsigned>(drop[l]),
                      static_cast<unsigned>(drop[L + l]),
                      static_cast<unsigned>(m / rows_per_pack),
                      __int_as_float(drop[2 * L + l])};
      y = d.apply(m % rows_per_pack, n, y);
    }
    out[o] = from_f32<O>(y);
  }
};

// out[m, n] = acc, stored as T.
template <class T>
struct StoreAs {
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    out[static_cast<size_t>(m) * ld + n] = from_f32<T>(acc);
  }
};

// out[i] = Σ_s part[s, i] over S partials of G floats, in order.
__global__ void sum_splits_kernel(const float* part, int S, long long G,
                                  float* out) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < G; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < S; ++q) s += part[static_cast<size_t>(q) * G + i];
    out[i] = s;
  }
}

inline void launch_sum(const float* part, int S, long long G, float* out,
                       cudaStream_t st) {
  const long long blocks = (G + 255) / 256 < 2048 ? (G + 255) / 256 : 2048;
  sum_splits_kernel<<<static_cast<int>(blocks), 256, 0, st>>>(part, S, G, out);
}

// Typed buffers carved out of one scratch allocation, each 256-byte
// aligned; with a null base only the bytes are counted.
struct Carve {
  char* base;
  size_t used = 0;
  template <class T>
  T* take(long long n) {
    T* p = base == nullptr ? nullptr : reinterpret_cast<T*>(base + used);
    used += (static_cast<size_t>(n) * sizeof(T) + 255) / 256 * 256;
    return p;
  }
};

// One D-MPNN conv layer over the whole batch, as conv_stack.cu (every
// layer) and fused_conv.cu (one layer) run it (conv_grid.cuh): `rows` edge rows in packs
// of te, messages through edge_nbr [rows, D] minus rev, scaled by
// mean_colscale(entries counted) when `mean`.
struct ConvGraph {
  const int *edge_nbr, *rev;
  int D, mean, te;
  long long rows;
};

// A conv layer's dpre = drop_l'(g)·act'(pre) over the n = rows·H floats,
// into dpre (which may be pre); with `out` instead (ReLU), dpre is
// drop_l'(g) where out > 0, else 0, and pre is not read; with neither
// (linear), dpre = drop_l'(g).  Then
// dh0 = skip·dpre, or dh0 += skip·dpre when `add` (when dh0 is set), and
// the block's share of Σ dpre·h0 in part[blockIdx.x·L + l]; kReduceBlocks
// blocks of kThreads, grid-stride.  g is G, h0 E, dh0 D, out OT (E by
// default; out is not deduced, so a nullptr passes).
template <class T>
struct NoDeduce {
  using type = T;
};

// Element k of the dpre pass from its loaded g, x (out, with `relu`;
// else pre, when `pre`), h0 and, with `add`, the old dh0: stores dpre
// (and dpre16) and dh0, and adds dpre·h0 to dot.
template <class D>
__device__ __forceinline__ void dpre_elem(long long k, float g, float x,
                                          float h, float d, bool relu,
                                          bool pre, const Dropout& dr,
                                          int act, int te, int H, float s,
                                          int add, float* dpre,
                                          __nv_bfloat16* dpre16, D* dh0,
                                          float& dot) {
  float v;
  if (relu) {
    v = x > 0.f ? g * dr.scale : 0.f;
  } else {
    const long long r = k / H;
    float gg = g;
    if (dr.on) {
      Dropout e = dr;
      e.pack = static_cast<unsigned>(r / te);
      gg = e.kept(static_cast<int>(r % te), static_cast<int>(k % H))
               ? gg * dr.scale
               : 0.f;
    }
    v = pre ? gg * k_dact(act, x) : gg;
  }
  dpre[k] = v;
  if (dpre16 != nullptr) dpre16[k] = __float2bfloat16_rn(v);
  dot = fmaf(v, h, dot);
  if (dh0 != nullptr) dh0[k] = from_f32<D>(add ? fmaf(s, v, d) : s * v);
}

// Block b of nb of the dpre pass (the grid-stride partition of
// dpre_kernel; `red` is kThreads floats of shared memory); with dpre16,
// dpre rounded to bf16 is stored there too.  Each thread takes its
// elements in order, four at a time: their loads first, then each
// element (dpre may be pre: an element is read before it is written).
template <class G, class E, class D, class OT>
__device__ __forceinline__ void dpre_part(
    const G* g, const float* pre, const OT* out, float* dpre, const E* h0,
    D* dh0, int add, const float* skip, const int* drop, int L, int l,
    int act, int te, int H, long long n, float* part,
    __nv_bfloat16* dpre16, int b, int nb, float* red) {
  Dropout dr{0, 0u, 0u, 0u, 1.f};
  if (drop != nullptr)
    dr = Dropout{1, static_cast<unsigned>(drop[l]),
                 static_cast<unsigned>(drop[L + l]), 0u,
                 __int_as_float(drop[2 * L + l])};
  const float s = *skip;
  const bool relu = out != nullptr, has_pre = pre != nullptr;
  const bool old = dh0 != nullptr && add;
  float dot = 0.f;
  constexpr int U = 4;
  const long long step = static_cast<long long>(nb) * kThreads;
  long long i = b * static_cast<long long>(kThreads) + threadIdx.x;
  for (; i + (U - 1) * step < n; i += U * step) {
    float gv[U], xv[U], hv[U], dv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long k = i + u * step;
      gv[u] = to_f32(g[k]);
      xv[u] = relu ? to_f32(out[k]) : (has_pre ? pre[k] : 0.f);
      hv[u] = to_f32(h0[k]);
      dv[u] = old ? to_f32(dh0[k]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      dpre_elem(i + u * step, gv[u], xv[u], hv[u], dv[u], relu, has_pre, dr,
                act, te, H, s, add, dpre, dpre16, dh0, dot);
  }
  for (; i < n; i += step)
    dpre_elem(i, to_f32(g[i]),
              relu ? to_f32(out[i]) : (has_pre ? pre[i] : 0.f),
              to_f32(h0[i]), old ? to_f32(dh0[i]) : 0.f, relu, has_pre, dr,
              act, te, H, s, add, dpre, dpre16, dh0, dot);
  __syncthreads();  // red may still be read by an earlier block's sum
  red[threadIdx.x] = dot;
  __syncthreads();
  for (int k = kThreads / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) red[threadIdx.x] += red[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) part[static_cast<size_t>(b) * L + l] = red[0];
}

template <class G, class E, class D, class OT = E>
__global__ void __launch_bounds__(kThreads)
    dpre_kernel(const G* g, const float* pre,
                const typename NoDeduce<OT>::type* out, float* dpre,
                const E* h0, D* dh0, int add, const float* skip,
                const int* drop, int L, int l, int act, int te, int H,
                long long n, float* part) {
  __shared__ float red[kThreads];
  dpre_part<G, E, D, OT>(g, pre, out, dpre, h0, dh0, add, skip, drop, L, l,
                         act, te, H, n, part, nullptr, blockIdx.x, gridDim.x,
                         red);
}

}  // namespace cgr
