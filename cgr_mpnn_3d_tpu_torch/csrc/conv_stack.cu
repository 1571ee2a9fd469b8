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
// Design.  On the TPU one grid step keeps a pack's edge state in VMEM for
// all L layers.  A te x H f32 state (400 KB at te = 256, H = 400) does not
// fit a block's 227 KB of shared memory, and messages gather rows from all
// over the pack, so here every layer is two grid-wide launches over the
// whole batch: the message gather (layered_common.cuh::gather_kernel) into
// a scratch t, then the product t·W[l] as one 64 x 64 output tile per
// block with bias, skip, activation and dropout in its epilogue
// (LayerEpi, which takes the pack of a row from the row index, never from
// blockIdx).  The launch boundary is the grid-wide barrier that the layer
// dependency needs, and every SM works at any p.
//
// Backward (pallas_stack.py:96-157): the replay keeps every layer's t and
// pre-activation in scratch (2·L·p·te·H floats, 1.4 GB at 436 packs of full
// width), then walks the layers in reverse:
//   dpre_l = drop_l'(g)·act'(pre_l),  dh0 += skip[l]·dpre_l,
//   dskip[l] = Σ dpre_l·h0 (per-block partials, summed in block order),
//   dW[l] = t_lᵀ·dpre_l, db[l] = Σ_r dpre_l (split-K partials, summed in
//   split order), g = adjoint of the messages applied to dpre_l·W[l]ᵀ,
// the adjoint being a gather through edge_nbr_rev (each entry scaled by its
// forward row's 1/degree for mean) minus the rev row, as in
// fused_model_bwd.cu; the stack's input cotangent is dh0 + g.  No float
// atomics: reruns are bit-identical.
//
// Bound.  Per layer 2·rows·H² FMA operations forward (about three times
// that backward, plus the replay) against 3·H·4 bytes per row: bound by
// f32 FMA throughput outside the tensor cores, not by memory.

#include "layered_common.cuh"

namespace {

using namespace cgr;

struct StackArgs {
  const float* h0;
  const int *edge_nbr, *rev;
  const float *w, *b, *skips;
  const int* drop;  // [3, L] dropout table, or nullptr in eval mode
  int p, te, H, L, D, act, mean;
  long long rows() const { return static_cast<long long>(p) * te; }
};

// Layer l of the forward: t = messages(h_in), h_out = layer(t); the
// pre-activation goes to `pre` when it is set.  h_out may be h_in: the
// gather has finished before the product starts.
void layer(const StackArgs& a, int l, const float* h_in, float* t, float* pre,
           float* h_out, float* rscale, cudaStream_t st) {
  const size_t HH = static_cast<size_t>(a.H) * a.H;
  launch_gather(GatherArgs{h_in, a.te, a.H, a.edge_nbr, a.D, a.rev, nullptr,
                           a.mean, a.te, a.rows(), t, rscale},
                st);
  launch_tile<false, false>(
      plain(t, a.H, a.w + l * HH, a.H, a.H), no_operands(),
      static_cast<int>(a.rows()), a.H,
      LayerEpi{a.b + static_cast<size_t>(l) * a.H, a.h0, a.skips + l, a.act,
               pre, h_out, a.H, a.drop, a.L, l, a.te},
      st);
}

// One layer's dpre over pre (in place), dh0 += skip·dpre, and the
// block's share of Σ dpre·h0 in part[blockIdx.x·L + l]; kReduceBlocks
// blocks of kThreads, grid-stride.
__global__ void __launch_bounds__(kThreads)
    dpre_kernel(const float* g, float* pre, const float* h0, float* dh0,
                const float* skips, const int* drop, int L, int l, int act,
                int te, int H, long long n, float* part) {
  __shared__ float red[kThreads];
  Dropout dr{0, 0u, 0u, 0u, 1.f};
  if (drop != nullptr)
    dr = Dropout{1, static_cast<unsigned>(drop[l]),
                 static_cast<unsigned>(drop[L + l]), 0u,
                 __int_as_float(drop[2 * L + l])};
  const float skip = skips[l];
  float dot = 0.f;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = i / H;
    const int c = static_cast<int>(i % H);
    float gg = g[i];
    if (dr.on) {
      dr.pack = static_cast<unsigned>(r / te);
      gg = dr.kept(static_cast<int>(r % te), c) ? gg * dr.scale : 0.f;
    }
    const float v = gg * k_dact(act, pre[i]);
    pre[i] = v;
    dot = fmaf(v, h0[i], dot);
    dh0[i] = fmaf(skip, v, dh0[i]);
  }
  red[threadIdx.x] = dot;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) part[static_cast<size_t>(blockIdx.x) * L + l] = red[0];
}

// a += b over n floats.
__global__ void add_kernel(float* a, const float* b, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    a[i] += b[i];
}

}  // namespace

// out [p·te, H] (the last layer's state); t [p·te, H] is scratch.
extern "C" int cgr_conv_stack_fwd(const float* h0, const int* edge_nbr,
                                  const int* rev, const float* w,
                                  const float* b, const float* skips,
                                  const int* drop, float* t, float* out,
                                  int p, int te, int H, int L,
                                  int D, int act, int mean, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StackArgs a{h0, edge_nbr, rev, w, b, skips, drop, p, te, H, L, D, act,
                    mean};
  for (int l = 0; l < L; ++l)
    layer(a, l, l == 0 ? h0 : out, t, nullptr, out, nullptr, st);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the backward's scratch: ts and pres [L, rows, H], h, dt, g
// [rows, H], escale [rows], the weight partials [S, H, H] and the dskip
// partials [kReduceBlocks, L].
extern "C" long long cgr_conv_stack_bwd_scratch_floats(int p, int te, int H,
                                                       int L, int S) {
  const long long rH = static_cast<long long>(p) * te * H;
  return (2LL * L + 3) * rH + static_cast<long long>(p) * te +
         static_cast<long long>(S) * H * H +
         static_cast<long long>(kReduceBlocks) * L;
}

// dh0 [rows, H], dw [L, H, H], db [L, H], dskip [L] from the cotangent g of
// the forward's output.
extern "C" int cgr_conv_stack_bwd(const float* h0, const int* edge_nbr,
                                  const int* rev, const int* edge_nbr_rev,
                                  const float* w, const float* b,
                                  const float* skips, const int* drop,
                                  const float* g_out, float* dh0, float* dw,
                                  float* db, float* dskip, float* scratch,
                                  int p, int te, int H, int L, int D, int act,
                                  int mean, int S, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StackArgs a{h0, edge_nbr, rev, w, b, skips, drop, p, te, H, L, D, act,
                    mean};
  const long long rows = a.rows(), rH = rows * H;
  const size_t HH = static_cast<size_t>(H) * H;
  float* ts = scratch;
  float* pres = ts + L * rH;
  float* h = pres + L * rH;
  float* dt = h + rH;
  float* g = dt + rH;
  float* escale = g + rH;
  float* wpart = escale + rows;
  float* dpart = wpart + static_cast<long long>(S) * HH;

  // replay, keeping every layer's messages and pre-activations
  for (int l = 0; l < L; ++l)
    layer(a, l, l == 0 ? h0 : h, ts + l * rH, pres + l * rH, h,
          l == 0 ? escale : nullptr, st);

  cudaMemsetAsync(dh0, 0, rH * sizeof(float), st);
  const float* g_in = g_out;
  for (int l = L - 1; l >= 0; --l) {
    float* dpre = pres + l * rH;
    dpre_kernel<<<kReduceBlocks, kThreads, 0, st>>>(
        g_in, dpre, h0, dh0, skips, drop, L, l, act, te, H, rH, dpart);
    launch_wgrad(ts + l * rH, H, dpre, H, rows, S, wpart, dw + l * HH, st);
    launch_colsum(dpre, H, rows, S, wpart, db + static_cast<size_t>(l) * H,
                  st);
    // dt = dpre·W[l]ᵀ, then g = the messages' adjoint applied to dt
    launch_tile<false, true>(plain(dpre, H, w + l * HH, H, H), no_operands(),
                             static_cast<int>(rows), H, StoreEpi{dt, H}, st);
    launch_gather(GatherArgs{dt, te, H, edge_nbr_rev, D, rev,
                             mean ? escale : nullptr, 0, te, rows, g, nullptr},
                  st);
    g_in = g;
  }
  add_kernel<<<2048, 256, 0, st>>>(dh0, g_in, rH);
  launch_sum(dpart, kReduceBlocks, L, dskip, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
