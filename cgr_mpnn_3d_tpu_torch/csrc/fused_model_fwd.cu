// Whole-model CGR-MPNN forward, one thread block per pack (CUDA C++, sm_90a).
//
// Replaces the TPU kernel cgr_mpnn_3d_tpu/ops/pallas_model.py::_fwd_call
// (-> _fwd_kernel -> _replay_forward), with the helpers it inlines from
// ops/pallas_fused.py (k_act, mean_colscale).  Per pack it computes, in f32
// and in eval mode (no dropout):
//
//   h0     = act(x[senders]·Wx + e·We + be)                   edge_init
//   for l < L:
//     t    = scale·Σ_d h[edge_nbr[:, d]] − h[rev]             messages
//     h    = act(t·Wc[l] + bc[l] + skip[l]·h0)                conv layer l
//   s      = scale·Σ_d h[node_inc[:, d]]                      readout sum
//   hn     = act(s·Ws + x·Wxn + ben)                          edge_to_node
//   pooled = scale·Σ_k hn[graph_nodes[:, k]]                  pooling
//   pred   = pooled·wffn + bffn                               ffn head
//
// "scale" is 1 for add and 1 / (number of counted entries) for mean; the
// rev term stays unscaled.  The wrapper and the plain PyTorch version of
// the same function are in ops/fused_model.py.
//
// Design.  The TPU kernel turns every gather into a one-hot matmul built in
// VMEM from transposed index rows.  Here the block gathers rows straight
// through the packer's ELL arrays.  Indices are global, with the sentinel
// equal to the row count; an index outside the block's own pack (the
// sentinel included) is skipped and never read through, which is what a
// never-matching one-hot column does on the TPU.  A te x H f32 tile is
// 400 KB at full width, more than the 227 KB of shared memory a block may
// have, so the edge states (h0, h, t), the node states (s, hn) and the
// pooled rows live in per-pack scratch in device memory that the wrapper
// allocates, and the phases are separated by __syncthreads().  The dense
// products are a shared-memory-tiled f32 FMA loop: 64 x 64 output tiles,
// 16-deep K steps, 4 x 4 outputs per thread.
//
// Bound.  Per pack the function needs about
// 2·tn·F·H + 2·te·Fe·H + L·2·te·H² + 2·tn·(F+H)·H f32 FMA operations, the x
// part of edge_init taken once per node (x[senders]·Wx = (x·Wx)[senders]),
// ≈ 0.43 GFLOP at full width (te=256, tn=128, F=270, Fe=14, H=400, L=4),
// against a few hundred KB of input per pack, so it is bound by f32 FMA
// throughput outside the tensor cores, not by memory.  This kernel
// multiplies the gathered x rows once per edge instead (2·te·F·H), ≈ 0.45
// GFLOP per pack, about 6% above what is needed.  One block per pack
// leaves most of the 132 SMs idle at a serving batch of p = 4 packs; that is
// accepted for this first version (bf16 wgmma, TMA and several blocks per
// pack are later work).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int BM = 64, BN = 64, BK = 16;
constexpr int TM = 4, TN = 4;          // thread (ty, tx): rows ty + 16 i, cols tx + 16 j

enum Act { kRelu = 0, kSilu = 1, kGelu = 2 };  // ops/kernel_math.KERNEL_ACTS

// k_act: relu, silu (x * sigmoid(x)) or exact-erf gelu.
__device__ __forceinline__ float k_act(int act, float x) {
  if (act == kRelu) return fmaxf(x, 0.f);
  if (act == kSilu) return x / (1.f + expf(-x));
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// mean_colscale: 1 / degree, where a row with no entries divides by 1.
__device__ __forceinline__ float mean_colscale(int count) {
  return 1.f / fmaxf(static_cast<float>(count), 1.f);
}

// Rows of a dense operand [*, K]: row m is base + m*K, or with `ids` the
// row ids[m] - lo when that lies in [0, n), and a zero row otherwise.
struct Rows {
  const float* base;
  int K;
  const int* ids;
  int lo, n;
  __device__ __forceinline__ const float* row(int m) const {
    if (ids == nullptr) return base + static_cast<size_t>(m) * K;
    const int r = ids[m] - lo;
    return (r >= 0 && r < n) ? base + static_cast<size_t>(r) * K : nullptr;
  }
};

struct Epilogue {
  const float* bias;   // [N]
  const float* h0;     // [M, N], added times `skip`; nullptr for none
  float skip;
  int act;
  float* out;          // [M, N]
};

struct Smem {
  float a[BK][BM + 1];  // A tile stored k-major; +1 keeps the stores conflict-free
  float b[BK][BN];
};

// acc += A[m0:m0+BM, :] · B[:, n0:n0+BN] with B row-major [A.K, N].
__device__ __forceinline__ void mma_tile(float (&acc)[TM][TN], const Rows& A,
                                         const float* __restrict__ B, int m0,
                                         int n0, int M, int N, Smem& sm) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < A.K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int mm = i / BK, kk = i % BK, m = m0 + mm, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < A.K) {
        const float* r = A.row(m);
        if (r != nullptr) v = r[k];
      }
      sm.a[kk][mm] = v;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int kk = i / BN, nn = i % BN, k = k0 + kk, n = n0 + nn;
      sm.b[kk][nn] =
          (k < A.K && n < N) ? B[static_cast<size_t>(k) * N + n] : 0.f;
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

// out = act(A1·B1 [+ A2·B2] + bias [+ skip·h0]) over an M x N output.
__device__ void dense(const Rows& A1, const float* __restrict__ B1,
                      const Rows* A2, const float* __restrict__ B2, int M,
                      int N, const Epilogue& ep, Smem& sm) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      float acc[TM][TN] = {};
      mma_tile(acc, A1, B1, m0, n0, M, N, sm);
      if (A2 != nullptr) mma_tile(acc, *A2, B2, m0, n0, M, N, sm);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = m0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = n0 + tx + 16 * j;
          if (m < M && n < N) {
            const size_t o = static_cast<size_t>(m) * N + n;
            float v = acc[i][j] + ep.bias[n];
            if (ep.h0 != nullptr) v = fmaf(ep.skip, ep.h0[o], v);
            ep.out[o] = k_act(ep.act, v);
          }
        }
      }
    }
  }
}

// out[r, :] = scale_r · Σ_d src[ids[r, d] - lo, :]  [- src[rev[r] - lo, :]]
// over R rows of width H; entries outside [0, n) are skipped, and
// scale_r = mean_colscale(entries counted) when `mean`, else 1.
__device__ void gather_sum(const float* __restrict__ src, int n, int lo,
                           const int* __restrict__ ids, int D,
                           const int* __restrict__ rev, bool mean, int R,
                           int H, float* __restrict__ out) {
  for (int i = threadIdx.x; i < R * H; i += kThreads) {
    const int r = i / H, c = i % H;
    const int* row = ids + static_cast<size_t>(r) * D;
    float sum = 0.f;
    int count = 0;
    for (int d = 0; d < D; ++d) {
      const int j = row[d] - lo;
      if (j >= 0 && j < n) {
        sum += src[static_cast<size_t>(j) * H + c];
        ++count;
      }
    }
    if (mean) sum *= mean_colscale(count);
    if (rev != nullptr) {
      const int j = rev[r] - lo;
      if (j >= 0 && j < n) sum -= src[static_cast<size_t>(j) * H + c];
    }
    out[i] = sum;
  }
}

// out[g] = pooled[g, :] · wffn + bffn, one warp per graph.
__device__ void head(const float* __restrict__ pooled, int tb, int H,
                     const float* __restrict__ wffn,
                     const float* __restrict__ bffn, float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < tb; g += kThreads / 32) {
    float v = 0.f;
    for (int c = lane; c < H; c += 32)
      v = fmaf(pooled[static_cast<size_t>(g) * H + c], wffn[c], v);
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) out[g] = v + bffn[0];
  }
}

struct Args {
  const float *x, *e;
  const int *senders, *edge_nbr, *rev, *node_inc, *graph_nodes;
  const float *wx, *we, *be, *wc, *bc, *skips, *ws, *wxn, *ben, *wffn, *bffn;
  float *h0, *h, *t, *s, *hn, *pooled, *out;
  int te, tn, tb, F, Fe, H, L, D, DN, act, mean_aggr, mean_pool;
};

__global__ void __launch_bounds__(kThreads)
    fused_model_fwd_kernel(const Args a) {
  __shared__ Smem sm;
  const int H = a.H;
  // the pack's first edge, node and graph (global ids)
  const int eb = blockIdx.x * a.te, nb = blockIdx.x * a.tn,
            gb = blockIdx.x * a.tb;
  const float* x = a.x + static_cast<size_t>(nb) * a.F;
  const float* e = a.e + static_cast<size_t>(eb) * a.Fe;
  float* h0 = a.h0 + static_cast<size_t>(eb) * H;
  float* h = a.h + static_cast<size_t>(eb) * H;
  float* t = a.t + static_cast<size_t>(eb) * H;
  float* s = a.s + static_cast<size_t>(nb) * H;
  float* hn = a.hn + static_cast<size_t>(nb) * H;
  float* pooled = a.pooled + static_cast<size_t>(gb) * H;

  // edge_init: h0 = act(x[senders]·Wx + e·We + be)
  const Rows x_src{x, a.F, a.senders + eb, nb, a.tn};
  const Rows e_rows{e, a.Fe, nullptr, 0, 0};
  dense(x_src, a.wx, &e_rows, a.we, a.te, H,
        Epilogue{a.be, nullptr, 0.f, a.act, h0}, sm);
  __syncthreads();

  const float* h_in = h0;
  for (int l = 0; l < a.L; ++l) {
    gather_sum(h_in, a.te, eb, a.edge_nbr + static_cast<size_t>(eb) * a.D,
               a.D, a.rev + eb, a.mean_aggr != 0, a.te, H, t);
    __syncthreads();
    const Rows t_rows{t, H, nullptr, 0, 0};
    dense(t_rows, a.wc + static_cast<size_t>(l) * H * H, nullptr, nullptr,
          a.te, H,
          Epilogue{a.bc + static_cast<size_t>(l) * H, h0, a.skips[l], a.act,
                   h},
          sm);
    __syncthreads();
    h_in = h;
  }

  // readout: hn = act(s·Ws + x·Wxn + ben), s = incoming sum of h
  gather_sum(h_in, a.te, eb, a.node_inc + static_cast<size_t>(nb) * a.D, a.D,
             nullptr, a.mean_aggr != 0, a.tn, H, s);
  __syncthreads();
  const Rows s_rows{s, H, nullptr, 0, 0};
  const Rows x_rows{x, a.F, nullptr, 0, 0};
  dense(s_rows, a.ws, &x_rows, a.wxn, a.tn, H,
        Epilogue{a.ben, nullptr, 0.f, a.act, hn}, sm);
  __syncthreads();

  gather_sum(hn, a.tn, nb, a.graph_nodes + static_cast<size_t>(gb) * a.DN,
             a.DN, nullptr, a.mean_pool != 0, a.tb, H, pooled);
  __syncthreads();
  head(pooled, a.tb, H, a.wffn, a.bffn, a.out + gb);
}

}  // namespace

// Launches one block per pack on `stream`; returns cudaGetLastError().
extern "C" int cgr_fused_model_fwd(
    const float* x, const float* e, const int* senders, const int* edge_nbr,
    const int* rev, const int* node_inc, const int* graph_nodes,
    const float* wx, const float* we, const float* be, const float* wc,
    const float* bc, const float* skips, const float* ws, const float* wxn,
    const float* ben, const float* wffn, const float* bffn, float* h0,
    float* h, float* t, float* s, float* hn, float* pooled, float* out, int p,
    int te, int tn, int tb, int F, int Fe, int H, int L, int D, int DN,
    int act, int mean_aggr, int mean_pool, void* stream) {
  const Args a{x,   e,   senders, edge_nbr, rev,    node_inc, graph_nodes,
               wx,  we,  be,      wc,       bc,     skips,    ws,
               wxn, ben, wffn,    bffn,     h0,     h,        t,
               s,   hn,  pooled,  out,      te,     tn,       tb,
               F,   Fe,  H,       L,        D,      DN,       act,
               mean_aggr, mean_pool};
  fused_model_fwd_kernel<<<p, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
