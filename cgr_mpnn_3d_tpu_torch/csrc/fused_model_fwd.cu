// Whole-model CGR-MPNN forward as one persistent grid (CUDA C++, sm_90a).
//
// Replaces the TPU kernel cgr_mpnn_3d_tpu/ops/pallas_model.py::_fwd_call
// (-> _fwd_kernel -> _replay_forward), with the helpers it inlines from
// ops/pallas_fused.py (k_act, mean_colscale, _hash_bits).  It computes the
// network of fused_model_common.cuh's phase functions with f32 or bf16
// products (the TPU kernel's mat_dtype, chosen by the mat_dtype argument;
// the inputs stay f32 and are rounded as they load, which gives the values
// of JAX's x.astype(bf16)); in train mode each conv layer's output goes
// through the hash dropout of the TPU kernel, bit for bit (same bits,
// threshold and f32 scale).  The wrapper and the plain PyTorch version of
// the same function are in ops/fused_model.py.
//
// Design.  The TPU kernel turns every gather into a one-hot matmul built in
// VMEM from transposed index rows.  Here every gather reads rows straight
// through the packer's ELL arrays.  A te x H f32 tile is 400 KB at full
// width, more than the 227 KB of shared memory a block may have, so the
// edge states (h0, h, t), the node states (s, hn) and the pooled rows live
// in per-pack scratch in device memory that the wrapper allocates.
// * One cooperative launch of one or two blocks on each SM, all resident
//   at once, which runs the forward's phases of the training
//   kernel's replay (fused_model_grid.cuh::forward_phases) behind grid
//   barriers: each phase's 64 x 64 tiles, row ranges and graphs of every
//   pack are dealt to the blocks at a fixed stride, so a serving batch of
//   four packs keeps every SM busy (one block per pack left 128 of the
//   132 SMs idle).  Every output element is written by one item and no
//   atomics are used: the predictions do not depend on the grid size.
// * The blocks per SM follow the training kernel's rule: one while
//   p·tiles_of(te, H) tiles fit the SMs (an SM to each tile: 0.41 against
//   0.48 ms with two at four packs), else two (22.3 against 41.3 ms at
//   436).  Unlike the training kernel's, this kernel fits two blocks an SM
//   without spilling, so one instantiation per mat_dtype serves both and
//   the rule sets only the grid.  The occupancy query is cached per
//   device and instantiation.
// * The states t and the pre-activations are not kept per layer (t is
//   overwritten by each layer's messages, no pre-activation is stored), and
//   the gathers compute their mean scales inline.
// * The dense products are shared-memory-tiled over 64 x 64 output tiles:
//   in f32 an FMA loop (16-deep K steps, 4 x 4 outputs per thread), in
//   bf16 the tensor cores (32-deep K steps staged as bf16, 8 warps of four
//   m16n8k16 mma.sync tiles each).
//
// Bound.  Per pack the function needs about
// 2·tn·F·H + 2·te·Fe·H + L·2·te·H² + 2·tn·(F+H)·H f32 FMA operations, the x
// part of edge_init taken once per node (x[senders]·Wx = (x·Wx)[senders]),
// ≈ 0.43 GFLOP at full width (te=256, tn=128, F=270, Fe=14, H=400, L=4),
// against a few hundred KB of input per pack, so it is bound by f32 FMA
// throughput outside the tensor cores, not by memory.  This kernel
// multiplies the gathered x rows once per edge instead (2·te·F·H), ≈ 0.45
// GFLOP per pack, about 6% above what is needed.  In bf16 the same
// products are tensor-core work, whose bound at 989 TFLOP/s is 15x lower:
// the staging loop (a scalar load, an index test and a conversion per
// element) and the gathers, not the products, then set the time.  At a
// serving batch of four packs each phase is one round of the grid, so
// the time is about one tile's or one row range's latency per phase.

#include "fused_model_grid.cuh"

namespace {

using namespace cgr;

struct Scratch {
  float *h0, *h, *t, *s, *hn, *pooled;
};

// Pack q's states in the scratch: one layer of t (stride 0), no
// pre-activations.
__device__ __forceinline__ FwdState state_of(const ModelArgs& a,
                                             const Scratch& sc, float* out,
                                             int q) {
  const size_t eb = static_cast<size_t>(q) * a.te * a.H,
               nb = static_cast<size_t>(q) * a.tn * a.H,
               gb = static_cast<size_t>(q) * a.tb;
  return FwdState{nullptr,         sc.h0 + eb, sc.t + eb, nullptr,
                  sc.h + eb,       sc.s + nb,  nullptr,   sc.hn + nb,
                  sc.pooled + gb * a.H,        out + gb,  0,
                  0};
}

// Two blocks an SM fit (≤ 128 registers): one instantiation serves both
// grids of blocks_per_sm.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
    fused_model_fwd_kernel(const ModelArgs a, const Scratch sc, float* out,
                           int p) {
  __shared__ SmemOf<kBf16> sm;
  CGR_STAMP(0, -1);
  forward_phases<kBf16>(
      a, p, [&](int q) { return state_of(a, sc, out, q); }, 0,
      [](int, int) {}, sm);
#ifdef CGR_PHASE_CLOCK
  cooperative_groups::this_grid().sync();
#endif
  CGR_STAMP(6, -1);
}

Instances kFns = {
    {reinterpret_cast<const void*>(&fused_model_fwd_kernel<false>),
     reinterpret_cast<const void*>(&fused_model_fwd_kernel<false>)},
    {reinterpret_cast<const void*>(&fused_model_fwd_kernel<true>),
     reinterpret_cast<const void*>(&fused_model_fwd_kernel<true>)}};

int launch(ModelArgs a, Scratch sc, float* out, int p, int mat_dtype,
           void* stream) {
  void* params[] = {&a, &sc, &out, &p};
  return launch_grid(kFns, mat_dtype, p, a.te, a.H, params, stream);
}

}  // namespace

// The grid of a launch at mat_dtype on p packs of te edge rows and width
// H, on the current device: returns the blocks (or minus a CUDA error
// code) and writes the blocks per SM and the SMs.
extern "C" int cgr_fused_model_fwd_grid(int mat_dtype, int p, int te, int H,
                                        int* per_sm, int* sms) {
  const void* fn = nullptr;
  int grid = 0;
  const int err = grid_of(kFns, mat_dtype, p, te, H, &fn, &grid, per_sm,
                          sms);
  return err != 0 ? -err : grid;
}

// Launches the forward on `stream`; returns 0 or a CUDA error code.
// `drop` is the [3, L] dropout table in train mode, or nullptr; mat_dtype
// is 0 for f32 and 1 for bf16 products (ops/kernel_math.MAT_DTYPES).
extern "C" int cgr_fused_model_fwd(
    const float* x, const float* e, const int* senders, const int* edge_nbr,
    const int* rev, const int* node_inc, const int* graph_nodes,
    const float* wx, const float* we, const float* be, const float* wc,
    const float* bc, const float* skips, const float* ws, const float* wxn,
    const float* ben, const float* wffn, const float* bffn, const int* drop,
    float* h0, float* h, float* t, float* s, float* hn, float* pooled,
    float* out, int p, int te, int tn, int tb, int F, int Fe, int H, int L,
    int D, int DN, int act, int mean_aggr, int mean_pool, int mat_dtype,
    void* stream) {
  const ModelArgs a{x,   e,   senders, edge_nbr, rev, node_inc, graph_nodes,
                    wx,  we,  be,      wc,       bc,  skips,    ws,
                    wxn, ben, wffn,    bffn,     drop, te,      tn,
                    tb,  F,   Fe,      H,        L,   D,        DN,
                    act, mean_aggr, mean_pool};
  return launch(a, Scratch{h0, h, t, s, hn, pooled}, out, p, mat_dtype,
                stream);
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
