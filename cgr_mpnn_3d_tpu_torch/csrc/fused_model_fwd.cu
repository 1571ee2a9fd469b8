// Whole-model CGR-MPNN forward, one thread block per pack (CUDA C++, sm_90a).
//
// Replaces the TPU kernel cgr_mpnn_3d_tpu/ops/pallas_model.py::_fwd_call
// (-> _fwd_kernel -> _replay_forward), with the helpers it inlines from
// ops/pallas_fused.py (k_act, mean_colscale, _hash_bits).  Per pack it
// computes the network of fused_model_common.cuh::forward_pack with f32 or
// bf16 products (the TPU kernel's mat_dtype, chosen by the mat_dtype
// argument; the inputs stay f32 and are rounded as they load, which gives
// the values of JAX's x.astype(bf16)); in train mode each conv layer's
// output goes through the hash dropout of the TPU kernel, bit for bit
// (same bits, threshold and f32 scale).  The wrapper and the plain PyTorch
// version of the same function are in ops/fused_model.py.
//
// Design.  The TPU kernel turns every gather into a one-hot matmul built in
// VMEM from transposed index rows.  Here the block runs every item of its
// pack's forward (the phase functions of fused_model_common.cuh, which the
// training kernel spreads over the whole grid) and gathers rows straight
// through the packer's ELL arrays.  A te x H f32 tile is 400 KB at full
// width, more than the 227 KB of shared memory a block may have, so the
// edge states (h0, h, t), the node states (s, hn) and the pooled rows live
// in per-pack scratch in device memory that the wrapper allocates, and the
// phases are separated by __syncthreads().  The dense products are
// shared-memory-tiled over 64 x 64 output tiles: in f32 an FMA loop (16-deep
// K steps, 4 x 4 outputs per thread), in bf16 the tensor cores (32-deep K
// steps staged as bf16, 8 warps of four m16n8k16 mma.sync tiles each).
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
// accepted for this first version (wgmma, TMA and several blocks per pack
// are later work).  In bf16 the same products are tensor-core work, whose
// bound at 989 TFLOP/s is 15x lower: the staging loop (a scalar load, an
// index test and a conversion per element) and the gathers, not the
// products, then set the time.

#include "fused_model_common.cuh"

namespace {

using namespace cgr;

struct Scratch {
  float *h0, *h, *t, *s, *hn, *pooled;
};

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    fused_model_fwd_kernel(const ModelArgs a, const Scratch sc, float* out) {
  __shared__ SmemOf<kBf16> sm;
  const int H = a.H;
  const size_t eb = static_cast<size_t>(blockIdx.x) * a.te,
               nb = static_cast<size_t>(blockIdx.x) * a.tn,
               gb = static_cast<size_t>(blockIdx.x) * a.tb;
  const FwdState st{nullptr,          sc.h0 + eb * H, sc.t + eb * H,
                    nullptr,          sc.h + eb * H,  sc.s + nb * H,
                    nullptr,          sc.hn + nb * H, sc.pooled + gb * H,
                    out + gb,         0,              0};
  forward_pack<kBf16>(a, st, blockIdx.x, sm);
}

}  // namespace

// Launches one block per pack on `stream`; returns cudaGetLastError().
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
  const Scratch sc{h0, h, t, s, hn, pooled};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mat_dtype == 1)
    fused_model_fwd_kernel<true><<<p, kThreads, 0, st>>>(a, sc, out);
  else
    fused_model_fwd_kernel<false><<<p, kThreads, 0, st>>>(a, sc, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
