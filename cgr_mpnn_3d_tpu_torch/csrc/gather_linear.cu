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
// every operand of a pack in VMEM.  Here:
// * the gathered operand t1 = G·xa is written once to device scratch by a
//   grid-wide gather (layered_common.cuh::gather_kernel), then the products
//   run as one 64 x 64 output tile per block over the whole batch, so every
//   SM works at any p;
// * Gᵀ is a gather through the transposed ELL array `adj` [p·ca, Dadj]
//   (node_out for edge_init, receivers for the readout), each entry scaled
//   by its forward row's scale_r (kept by the forward gather): no atomics;
// * the weight gradients are split-K products: S partials over fixed row
//   ranges, summed in split order by a second launch, so reruns are
//   bit-identical.
//
// Bound.  Per call the products need 2·rows·(FA + FB)·H multiply-adds
// (forward; about three times that backward) against a few hundred bytes
// per row, so at the model's widths (FA, FB, H ≥ 14, H = 400) the kernel is
// bound by the products (f32 FMA outside the tensor cores, 67 TFLOP/s, or
// the bf16 tensor cores), not by memory.  The tile loop is the simple one
// of fused_model_common.cuh (no wgmma, no TMA).
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
// (launch_pool): a group can hold thousands of entries (a long chain's
// nodes), which one thread per column would walk alone; its backward reads
// dout = g + gpool[group of the row] (through node_group, the
// transpose).  The gather takes xr as
// its extra term (layered_common.cuh), unrounded, dt is written straight
// into dxr, and the rest is K5's backward.  mat = 1 is K5's bf16 with the
// readout's f32 output: xa, xb, dxa and dxb bf16; xr, dxr, out, g, the
// pool and its cotangent f32.  As in pallas_glin.py at mat_dtype bf16, xr
// joins the gathered sum in f32 and t1 is rounded once (:316-319), the
// pool sums bf16(out) and the backward adds bf16(gpool) (:497, :527), and
// dxr is the f32 dt = bf16(dpre)·bf16(Wa)ᵀ, rounded again where dxa
// gathers it.

#include "layered_common.cuh"

namespace {

using namespace cgr;

// dpre = g·act'(acc + bias): the backward's pre-activation recomputed; g
// of type O.
template <class O>
struct DpreEpi {
  const float* bias;
  const O* g;
  int act;
  float* dpre;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    const size_t o = static_cast<size_t>(m) * ld + n;
    dpre[o] = to_f32(g[o]) * k_dact(act, acc + bias[n]);
  }
};

// ReLU: dpre = g where out > 0, else 0.
template <class O>
__global__ void relu_dpre_kernel(const O* out, const O* g, long long n,
                                 float* dpre) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    dpre[i] = to_f32(out[i]) > 0.f ? to_f32(g[i]) : 0.f;
}

struct Dims {
  int p, R, ca, FA, FB, H, D, act, mean;
  long long rows() const { return static_cast<long long>(p) * R; }
};

// t1 = G·xa (+ xr, f32 rows aligned with t1's, when set) into scratch,
// with each forward row's scale in rscale (when set).
template <bool kBf16>
void gather_t1(const Elem<kBf16>* xa, const float* xr, const int* idx,
               const Dims& d, Elem<kBf16>* t1, float* rscale,
               cudaStream_t st) {
  using E = Elem<kBf16>;
  launch_gather<kBf16>(GatherArgs<E, E>{xa, d.ca, d.FA, idx, d.D, nullptr,
                                        nullptr, d.mean, d.R, d.rows(), t1,
                                        rscale, nullptr, xr, nullptr, 0, 1},
                       st);
}

// dout[i, :] = g[i, :] + gpool[q, :] with q = node_group[i] when it lies in
// the GP groups of row i's pack (R rows per pack), else g[i, :]; gpool
// rounded as an operand.
template <bool kBf16>
__global__ void add_group_kernel(const float* g, const float* gpool,
                                 const int* node_group, long long rows, int R,
                                 int GP, int H, float* dout) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < rows * H; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / H, lo = (r / R) * GP;
    const long long q = node_group[r] - lo;
    float v = g[i];
    if (q >= 0 && q < GP) v += operand<kBf16>(gpool[(lo + q) * H + i % H]);
    dout[i] = v;
  }
}

template <bool kBf16, class O>
void forward(const void* xa_, const void* xb_, const int* idx,
             const float* wa, const float* wb, const float* b, void* t1_,
             void* out, const Dims& d, cudaStream_t st,
             const float* xr = nullptr) {
  using E = Elem<kBf16>;
  const E* xa = static_cast<const E*>(xa_);
  const E* xb = static_cast<const E*>(xb_);
  E* t1 = static_cast<E*>(t1_);
  gather_t1<kBf16>(xa, xr, idx, d, t1, nullptr, st);
  launch_tile<kBf16, false, false>(
      plain(t1, d.FA, wa, d.H, d.FA), plain(xb, d.FB, wb, d.H, d.FB),
      static_cast<int>(d.rows()), d.H,
      LayerEpi<O>{b, nullptr, nullptr, d.act, nullptr, static_cast<O*>(out),
                  d.H, nullptr, 0, 0, d.R},
      st);
}

// dt = dpre·Waᵀ is formed when dxa is wanted or keep_dt is set (the EP
// readout's dxr is dt itself), and stored as DT (the Elem operand dxa
// gathers, or f32 for dxr).
template <bool kBf16, class O, class DT = Elem<kBf16>>
void backward(const void* xa_, const void* xb_, const int* idx,
              const int* adj, const float* wa, const float* wb,
              const float* b, const void* out_, const void* g_, void* dxa_,
              void* dxb_, float* dwa, float* dwb, float* db, void* t1_,
              void* dt_, float* dpre, float* rscale, float* part,
              const Dims& d, int Dadj, int S, cudaStream_t st,
              const float* xr = nullptr, bool keep_dt = false) {
  using E = Elem<kBf16>;
  const E* xa = static_cast<const E*>(xa_);
  const E* xb = static_cast<const E*>(xb_);
  const O* out = static_cast<const O*>(out_);
  const O* g = static_cast<const O*>(g_);
  E* t1 = static_cast<E*>(t1_);
  DT* dt = static_cast<DT*>(dt_);
  E *dxa = static_cast<E*>(dxa_), *dxb = static_cast<E*>(dxb_);
  const long long rows = d.rows();
  const int M = static_cast<int>(rows), H = d.H, FA = d.FA, FB = d.FB;
  gather_t1<kBf16>(xa, xr, idx, d, t1, rscale, st);
  if (d.act == kRelu) {
    relu_dpre_kernel<O><<<2048, 256, 0, st>>>(out, g, rows * H, dpre);
  } else {
    launch_tile<kBf16, false, false>(plain(t1, FA, wa, H, FA),
                                     plain(xb, FB, wb, H, FB), M, H,
                                     DpreEpi<O>{b, g, d.act, dpre, H}, st);
  }
  const Operands none = no_operands();
  if (dxb != nullptr)
    launch_tile<kBf16, false, true>(plain(dpre, H, wb, H, H), none, M, FB,
                                    StoreAs<E>{dxb, FB}, st);
  if (dxa != nullptr || keep_dt)
    launch_tile<kBf16, false, true>(plain(dpre, H, wa, H, H), none, M, FA,
                                    StoreAs<DT>{dt, FA}, st);
  if (dxa != nullptr)
    launch_gather<kBf16>(GatherArgs<DT, E>{dt, d.R, FA, adj, Dadj, nullptr,
                                          d.mean ? rscale : nullptr, 0, d.ca,
                                          static_cast<long long>(d.p) * d.ca,
                                          dxa, nullptr},
                         st);
  if (dwa != nullptr)
    launch_wgrad<kBf16>(t1, FA, dpre, H, rows, S, part, dwa, st);
  if (dwb != nullptr)
    launch_wgrad<kBf16>(xb, FB, dpre, H, rows, S, part, dwb, st);
  if (db != nullptr) launch_colsum(dpre, H, rows, S, part, db, st);
}

}  // namespace

// out [p·R, H]; t1 [p·R, FA] is scratch.  xa, xb and t1 are f32, or bf16
// with mat = 1; out is bf16 when out_bf16 (mat = 1 only), else f32.
extern "C" int cgr_gather_linear_fwd(const void* xa, const void* xb,
                                     const int* idx, const float* wa,
                                     const float* wb, const float* b,
                                     void* t1, void* out, int p, int R,
                                     int ca, int FA, int FB, int H, int D,
                                     int act, int mean, int mat, int out_bf16,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{p, R, ca, FA, FB, H, D, act, mean};
  if (!mat)
    forward<false, float>(xa, xb, idx, wa, wb, b, t1, out, d, st);
  else if (out_bf16)
    forward<true, __nv_bfloat16>(xa, xb, idx, wa, wb, b, t1, out, d, st);
  else
    forward<true, float>(xa, xb, idx, wa, wb, b, t1, out, d, st);
  return static_cast<int>(cudaGetLastError());
}

// Cotangents from g [p·R, H] (the forward's output `out` given; both of
// out's type): dxa [p·ca, FA] through adj [p·ca, Dadj] and dxb [p·R, FB]
// of xa's type, dwa [FA, H], dwb [FB, H], db [H]; a null output is
// skipped.  Scratch: t1 and dt [p·R, FA] of xa's type, dpre [p·R, H],
// rscale [p·R], part [S·max(FA, FB)·H].
extern "C" int cgr_gather_linear_bwd(
    const void* xa, const void* xb, const int* idx, const int* adj,
    const float* wa, const float* wb, const float* b, const void* out,
    const void* g, void* dxa, void* dxb, float* dwa, float* dwb, float* db,
    void* t1, void* dt, float* dpre, float* rscale, float* part, int p,
    int R, int ca, int FA, int FB, int H, int D, int Dadj, int act, int mean,
    int S, int mat, int out_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{p, R, ca, FA, FB, H, D, act, mean};
  if (!mat)
    backward<false, float>(xa, xb, idx, adj, wa, wb, b, out, g, dxa, dxb,
                           dwa, dwb, db, t1, dt, dpre, rscale, part, d, Dadj,
                           S, st);
  else if (out_bf16)
    backward<true, __nv_bfloat16>(xa, xb, idx, adj, wa, wb, b, out, g, dxa,
                                  dxb, dwa, dwb, db, t1, dt, dpre, rscale,
                                  part, d, Dadj, S, st);
  else
    backward<true, float>(xa, xb, idx, adj, wa, wb, b, out, g, dxa, dxb, dwa,
                          dwb, db, t1, dt, dpre, rscale, part, d, Dadj, S,
                          st);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// K11's group pool as an ordered split sum.  Each group's pool_ell row
// [DN] is cut into chunks of kPoolChunk entries (their count a function of
// DN alone).  Pass 1 takes one (group, chunk) item per block at a time:
// warp 0 keeps the chunk's entries inside the group's pack, in entry
// order, and the block sums their rows of out in that order (coalesced
// row reads, each operand rounded as a gather's) into part[group, chunk,
// :], marking in used[group, chunk] whether the chunk had an entry.  Pass 2
// sums each group's used partials in chunk order.  With one chunk, pass 1
// writes the pool itself.  No atomics: reruns are bit-identical and the
// result does not depend on either grid.
constexpr int kPoolChunk = 32;    // entries of a chunk: one warp's ballot
constexpr int kPoolThreads = 128;
constexpr int kPoolBlocks = 4096;

template <bool kBf16>
__global__ void __launch_bounds__(kPoolThreads)
    pool_part_kernel(const float* out, int R, int H, const int* pool_ell,
                     int GP, int DN, int chunks, long long items, float* part,
                     int* used) {
  __shared__ int rows[kPoolChunk];
  __shared__ int n_rows;
  const int lane = threadIdx.x;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long g = it / chunks, lo = (g / GP) * R;
    if (lane < kPoolChunk) {
      const int d = static_cast<int>(it % chunks) * kPoolChunk + lane;
      const long long j = d < DN ? pool_ell[g * DN + d] - lo : -1;
      const bool in = j >= 0 && j < R;
      const unsigned mask = __ballot_sync(0xffffffffu, in);
      if (in) rows[__popc(mask & ((1u << lane) - 1u))] = static_cast<int>(j);
      if (lane == 0) n_rows = __popc(mask);
    }
    __syncthreads();
    const int n = n_rows;
    if (used != nullptr && threadIdx.x == 0) used[it] = n > 0;
    if (n > 0 || used == nullptr) {
      for (int c = threadIdx.x; c < H; c += kPoolThreads) {
        float sum = 0.f;
#pragma unroll 8
        for (int i = 0; i < n; ++i)
          sum += operand<kBf16>(out[(lo + rows[i]) * H + c]);
        part[it * H + c] = sum;
      }
    }
    __syncthreads();  // rows and n_rows are the next item's
  }
}

__global__ void pool_sum_kernel(const float* part, const int* used,
                                long long groups, int chunks, int H,
                                float* pool) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < groups * H; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long g = i / H;
    float s = 0.f;
    for (int k = 0; k < chunks; ++k)
      if (used[g * chunks + k]) s += part[(g * chunks + k) * H + i % H];
    pool[i] = s;
  }
}

// pool [p·GP, H] from out [p·R, H] through pool_ell [p·GP, DN]; part
// [p·GP·chunks, H] and used [p·GP·chunks] are scratch when chunks > 1.
template <bool kBf16>
void launch_pool(const float* out, const int* pool_ell, float* pool,
                 float* part, int* used, const Dims& d, int GP, int DN,
                 int chunks, cudaStream_t st) {
  const long long groups = static_cast<long long>(d.p) * GP,
                  items = groups * chunks;
  if (items == 0) return;
  const bool split = chunks > 1;
  pool_part_kernel<kBf16>
      <<<static_cast<unsigned>(items < kPoolBlocks ? items : kPoolBlocks),
         kPoolThreads, 0, st>>>(out, d.R, d.H, pool_ell, GP, DN, chunks,
                                items, split ? part : pool,
                                split ? used : nullptr);
  if (split) {
    const long long blocks = (groups * d.H + 255) / 256;
    pool_sum_kernel<<<static_cast<unsigned>(blocks < 2048 ? blocks : 2048),
                      256, 0, st>>>(part, used, groups, chunks, d.H, pool);
  }
}

template <bool kBf16>
void r_forward(const void* xa, const float* xr, const void* xb,
               const int* idx, const int* pool_ell, const float* wa,
               const float* wb, const float* b, void* t1, float* out,
               float* pool, float* part, int* used, const Dims& d, int GP,
               int DN, int chunks, cudaStream_t st) {
  forward<kBf16, float>(xa, xb, idx, wa, wb, b, t1, out, d, st, xr);
  if (pool_ell == nullptr) return;
  launch_pool<kBf16>(out, pool_ell, pool, part, used, d, GP, DN, chunks, st);
}

template <bool kBf16>
void r_backward(const void* xa, const float* xr, const void* xb,
                const int* idx, const int* adj, const int* node_group,
                const float* wa, const float* wb, const float* b,
                const float* out, const float* g, const float* gpool,
                void* dxa, float* dxr, void* dxb, float* dwa, float* dwb,
                float* db, void* t1, float* dt, float* dpre, float* rscale,
                float* part, float* dout, const Dims& d, int Dadj, int GP,
                int S, cudaStream_t st) {
  if (gpool != nullptr) {
    add_group_kernel<kBf16><<<2048, 256, 0, st>>>(g, gpool, node_group,
                                                  d.rows(), d.R, GP, d.H,
                                                  dout);
    g = dout;
  }
  backward<kBf16, float, float>(xa, xb, idx, adj, wa, wb, b, out, g, dxa,
                                dxb, dwa, dwb, db, t1,
                                dxr != nullptr ? dxr : dt, dpre, rscale, part,
                                d, Dadj, S, st, xr, dxr != nullptr);
}

}  // namespace

// The EP readout (K10; K11 when pool_ell is set): out [p·R, H] and, with
// the pool, pool [p·GP, H] through pool_ell [p·GP, DN] (node slots of each
// group, sentinel-padded), split into `chunks` = max(1, ceil(DN /
// kPoolChunk)) chunks (part [p·GP·chunks, H] f32 and used [p·GP·chunks]
// int32 are scratch when chunks > 1; another count is refused); t1 [p·R,
// FA] is scratch of xa's type.  xa, xb and t1 are f32, or bf16 with mat =
// 1; xr, out and the pool are f32.
extern "C" int cgr_gather_linear_r_fwd(const void* xa, const float* xr,
                                       const void* xb, const int* idx,
                                       const int* pool_ell, const float* wa,
                                       const float* wb, const float* b,
                                       void* t1, float* out, float* pool,
                                       float* part, int* used, int p, int R,
                                       int ca, int FA, int FB, int H, int D,
                                       int GP, int DN, int chunks, int act,
                                       int mean, int mat, void* stream) {
  if (pool_ell != nullptr &&
      chunks != (DN > kPoolChunk ? (DN + kPoolChunk - 1) / kPoolChunk : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{p, R, ca, FA, FB, H, D, act, mean};
  (mat ? r_forward<true> : r_forward<false>)(xa, xr, xb, idx, pool_ell, wa,
                                             wb, b, t1, out, pool, part, used,
                                             d, GP, DN, chunks, st);
  return static_cast<int>(cudaGetLastError());
}

// Cotangents of the EP readout from g [p·R, H] (and, for K11, gpool
// [p·GP, H] through node_group [p·R]): dxa, dxr, dxb, dwa, dwb, db as
// K5's with dxr = dpre·Waᵀ; a null output is skipped.  dxa and dxb take
// xa's type, the rest is f32.  Scratch: t1 [p·R, FA] of xa's type, dt
// [p·R, FA], dpre, rscale, part as K5's (f32), and dout [p·R, H] for K11.
extern "C" int cgr_gather_linear_r_bwd(
    const void* xa, const float* xr, const void* xb, const int* idx,
    const int* adj, const int* node_group, const float* wa, const float* wb,
    const float* b, const float* out, const float* g, const float* gpool,
    void* dxa, float* dxr, void* dxb, float* dwa, float* dwb, float* db,
    void* t1, float* dt, float* dpre, float* rscale, float* part,
    float* dout, int p, int R, int ca, int FA, int FB, int H, int D,
    int Dadj, int GP, int act, int mean, int S, int mat, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{p, R, ca, FA, FB, H, D, act, mean};
  (mat ? r_backward<true> : r_backward<false>)(
      xa, xr, xb, idx, adj, node_group, wa, wb, b, out, g, gpool, dxa, dxr,
      dxb, dwa, dwb, db, t1, dt, dpre, rscale, part, dout, d, Dadj, GP, S,
      st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
