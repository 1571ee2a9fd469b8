// The whole-model kernels as one cooperative grid over the card, shared by
// the forward (fused_model_fwd.cu, K3f) and the training and VJP kernel
// (fused_model_bwd.cu, K2 and K3b): how a phase's items are dealt to the
// blocks, the forward's phase sequence (pallas_model.py::_replay_forward),
// the choice of instantiation and grid, and the phase clock of
// tools/k2_phases.py.
//
// A phase is cut into items of every pack -- a 64 x 64 output tile of a
// product, a range of rows of a gather, a graph of the pooling -- and block
// b takes items b, b + grid, b + 2·grid, ...; phases are separated by grid
// barriers.  Every output element is written by exactly one item, and an
// item's arithmetic does not depend on the block that runs it, so the
// result does not depend on the grid size.

#pragma once

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <utility>

#include "fused_model_common.cuh"

namespace cgr {

#ifdef CGR_PHASE_CLOCK
// The phase clock of tools/k2_phases.py (never in the shipped build):
// thread 0 of block 0 stamps %globaltimer after each grid barrier.  The
// forward stamps ids 0-6, the training kernel all of them.  Each kernel
// source is a library of its own and includes this header once.
constexpr int kMaxStamps = 256;
__device__ unsigned long long phase_ns[kMaxStamps];
__device__ int phase_id[kMaxStamps];
__device__ int phase_count;
const char* const kPhaseNames[] = {
    "start", "edge_init", "gather", "conv", "readout gather", "readout",
    "pool+head", "pool adjoint", "readout grads", "adjoint+act", "dt",
    "edge_init adjoint", "edge_init grads", "pack sum"};
__device__ void phase_stamp(int id, int layer) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (id == 0) phase_count = 0;
    const int i = phase_count;
    if (i < kMaxStamps) {
      phase_ns[i] = t;
      phase_id[i] = id * 256 + (layer < 0 ? 255 : layer);
      phase_count = i + 1;
    }
  }
}
#define CGR_STAMP(id, layer) phase_stamp(id, layer)

// Copies the stamps of the last launch (at most n) to the host: ns[i] the
// %globaltimer reading, ids[i] = phase · 256 + layer (255: none); returns
// their count or -1.
extern "C" int cgr_phase_clock_read(long long* ns, int* ids, int n) {
  int count = 0;
  if (cudaMemcpyFromSymbol(&count, phase_count, sizeof(int)) != cudaSuccess)
    return -1;
  count = count < n ? count : n;
  if (cudaMemcpyFromSymbol(ns, phase_ns, count * sizeof(long long)) !=
          cudaSuccess ||
      cudaMemcpyFromSymbol(ids, phase_id, count * sizeof(int)) != cudaSuccess)
    return -1;
  return count;
}

extern "C" const char* cgr_phase_name(int id) {
  constexpr int n = sizeof(kPhaseNames) / sizeof(kPhaseNames[0]);
  return id >= 0 && id < n ? kPhaseNames[id] : nullptr;
}
#else
#define CGR_STAMP(id, layer)
#endif

// Rows of an elementwise or gather item: few at a small batch, so that
// the items of a few packs spread over the grid, more at a large one, so
// that their fixed costs stay small.  A function of the batch alone: the
// training kernel's column sums are chunked by it, and so their result
// does not depend on the grid.
constexpr int kRowsSmall = 4, kRowsLarge = 16;
__host__ __device__ inline int rows_per_item(int p) {
  return p <= 32 ? kRowsSmall : kRowsLarge;
}

__host__ __device__ inline int row_items(int n, int rows) {
  return (n + rows - 1) / rows;
}

// Rows [r0, r1) of row item j of n rows.
__device__ __forceinline__ void row_span(int j, int rows, int n, int& r0,
                                         int& r1) {
  r0 = j * rows;
  r1 = r0 + rows < n ? r0 + rows : n;
}

// Calls fn(it) for this block's items of a phase of n items: b, b + grid,
// b + 2·grid, ...
template <class Fn>
__device__ __forceinline__ void items(int n, Fn&& fn) {
  for (int it = blockIdx.x; it < n; it += gridDim.x) fn(it);
}

// The forward of p packs (fused_model_common.cuh's phase functions) as
// five phases behind grid barriers, then pool+head, after which the caller
// places its own barrier when a later phase reads the predictions:
//
//   edge_init          tiles of h0 (and `extra` items)
//   gather[l], conv[l] messages t_l; t_l·Wc[l] tiles -> h, for each layer
//   readout gather     s;  readout: s·Ws + x·Wxn tiles -> hn
//   pool+head          one item per graph slot
//
// state(q) is pack q's FwdState.  Each pack adds n_extra items to the
// edge_init phase, run as extra(q, j) (the training kernel's mean scales).
template <bool kBf16, class State, class Extra>
__device__ void forward_phases(const ModelArgs& a, int p, State&& state,
                               int n_extra, Extra&& extra,
                               SmemOf<kBf16>& sm) {
  const cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int rows = rows_per_item(p), t_e = tiles_of(a.te, a.H),
            t_n = tiles_of(a.tn, a.H), r_e = row_items(a.te, rows),
            r_n = row_items(a.tn, rows);
  items(p * (t_e + n_extra), [&](int it) {
    const int q = it / (t_e + n_extra), j = it % (t_e + n_extra);
    if (j < t_e)
      edge_init_tile<kBf16>(a, state(q), q, j, sm);
    else
      extra(q, j - t_e);
  });
  grid.sync();
  CGR_STAMP(1, -1);
  for (int l = 0; l < a.L; ++l) {
    items(p * r_e, [&](int it) {
      int r0, r1;
      row_span(it % r_e, rows, a.te, r0, r1);
      message_rows<kBf16>(a, state(it / r_e), it / r_e, l, r0, r1);
    });
    grid.sync();
    CGR_STAMP(2, l);
    items(p * t_e, [&](int it) {
      conv_tile<kBf16>(a, state(it / t_e), it / t_e, l, it % t_e, sm);
    });
    grid.sync();
    CGR_STAMP(3, l);
  }
  items(p * r_n, [&](int it) {
    int r0, r1;
    row_span(it % r_n, rows, a.tn, r0, r1);
    readout_rows<kBf16>(a, state(it / r_n), it / r_n, r0, r1);
  });
  grid.sync();
  CGR_STAMP(4, -1);
  items(p * t_n, [&](int it) {
    readout_tile<kBf16>(a, state(it / t_n), it / t_n, it % t_n, sm);
  });
  grid.sync();
  CGR_STAMP(5, -1);
  items(p * a.tb, [&](int it) {
    const int g = it % a.tb;
    pool_head<kBf16>(a, state(it / a.tb), it / a.tb, g, g + 1);
    __syncthreads();
  });
}

// The blocks per SM a launch takes, and the instantiation built for them:
// one (no register spill, an SM to itself) while the batch's largest tile
// phases (p·tiles_of(te, H) tiles) fit the SMs, else two, where more
// blocks hide more latency (CGR_BLOCKS_PER_SM forces one of them).
inline int blocks_per_sm(int p, int te, int H, int sms) {
#ifdef CGR_BLOCKS_PER_SM
  return CGR_BLOCKS_PER_SM;
#else
  return static_cast<long long>(p) * tiles_of(te, H) <= sms ? 1 : 2;
#endif
}

// The instantiations of a kernel: fn[mat_dtype][blocks per SM - 1] (one
// function may serve both counts).
using Instances = const void* const[2][2];

// The SMs of the current device (*sms) and the blocks of `fn` (kThreads
// threads and `smem` bytes of dynamic shared memory) that fit on one of
// them at once (*fit; not asked with a null fn), each asked of the runtime
// once per device and (device, function) and read from a cache after;
// with `smem`, fn's dynamic shared memory limit is raised to it before
// that one query.  Returns 0 or a CUDA error code.
inline int occupancy_of(const void* fn, size_t smem, int* fit, int* sms) {
  static std::mutex lock;
  static std::map<int, int> sms_of;                            // device
  static std::map<std::pair<int, const void*>, int> fit_of;    // blocks/SM
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> guard(lock);
  auto s = sms_of.find(dev);
  if (s == sms_of.end()) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    s = sms_of.emplace(dev, n).first;
  }
  *sms = s->second;
  if (fn == nullptr) return 0;
  auto f = fit_of.find({dev, fn});
  if (f == fit_of.end()) {
    if (smem > 0) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    f = fit_of.emplace(std::make_pair(dev, fn), n).first;
  }
  *fit = f->second;
  return 0;
}

// The grid of `want` blocks on each SM, or as many as fit at once if fewer
// do (at most CGR_GRID_BLOCKS blocks when that is defined): *grid blocks,
// *per_sm of them an SM.  Returns 0 or a CUDA error code.
inline int grid_for(const void* fn, size_t smem, int want, int* grid,
                    int* per_sm, int* sms) {
  int fit = 0;
  const int err = occupancy_of(fn, smem, &fit, sms);
  if (err != 0) return err;
  if (fit < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *per_sm = fit < want ? fit : want;
  *grid = *per_sm * *sms;
#ifdef CGR_GRID_BLOCKS
  *grid = *grid < CGR_GRID_BLOCKS ? *grid : CGR_GRID_BLOCKS;
#endif
  return 0;
}

// The cooperative grid of a launch of p packs of te edge rows at width H:
// the instantiation (*fn) for the blocks per SM that blocks_per_sm picks,
// and grid_for's grid for it, with the blocks per SM and the SMs.  The
// occupancy query runs once per (device, instantiation); later launches
// read the cache.  Returns 0 or a CUDA error code.
inline int grid_of(Instances& fns, int mat_dtype, int p, int te, int H,
                   const void** fn, int* grid, int* per_sm, int* sms) {
  int fit = 0;
  const int err = occupancy_of(nullptr, 0, &fit, sms);  // the SMs
  if (err != 0) return err;
  const int want = blocks_per_sm(p, te, H, *sms);
  *fn = fns[mat_dtype == 1][want - 1];
  return grid_for(*fn, 0, want, grid, per_sm, sms);
}

// One cooperative launch of `fn` over `grid` blocks of kThreads with
// `smem` bytes of dynamic shared memory; returns 0 or a CUDA error code (a
// grid that cannot be co-resident is cudaErrorCooperativeLaunchTooLarge,
// never a hang).
inline int launch_cooperative(const void* fn, int grid, size_t smem,
                              void** params, void* stream) {
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kThreads), params, smem,
      static_cast<cudaStream_t>(stream)));
}

// One cooperative launch of `params` on `stream` over the grid of
// grid_of; returns 0 or a CUDA error code.
inline int launch_grid(Instances& fns, int mat_dtype, int p, int te, int H,
                       void** params, void* stream) {
  const void* fn = nullptr;
  int grid = 0, per_sm = 0, sms = 0;
  const int err = grid_of(fns, mat_dtype, p, te, H, &fn, &grid, &per_sm,
                          &sms);
  if (err != 0) return err;
  return launch_cooperative(fn, grid, 0, params, stream);
}

}  // namespace cgr
