// The hop exchange of edge partitioning (CUDA C++, sm_90a): K12.
//
// Replaces the TPU kernel cgr_mpnn_3d_tpu/parallel/rdma_exchange.py::
// _exchange_call (ring_exchange_rdma), which pushes every hop block of the
// hop-aligned wire as a concurrent remote copy.  Each of the n_ep shards
// holds a wire buffer [TW, H]; hop h owns the rows [off_h, off_h + S_h)
// and moves them from shard k to shard k + h (inverse: k - h), mod n_ep:
//
//   out[(k ± h) mod n][off_h : off_h + S_h] = buf[k][off_h : off_h + S_h]
//
// a blockwise permutation, so its adjoint is the inverse exchange.  The
// semantics are ep_pack._ring_move's (the plain version) bit for bit.
//
// Design.  On one card every shard's buffer lies in the same memory, so
// the exchange is one copy kernel that moves every active hop block of
// every shard in one launch (the TPU kernel also starts every hop's copy
// before it waits on any).  The grid runs over (row block, active hop,
// shard); a block copies its share of one hop block of one shard with
// 16-byte vector loads and stores when the source, the destination and
// the length are 16-byte aligned (rows of H f32 or bf16 values with H a
// multiple of 8), else byte by byte.  The outputs are one allocation
// [n_ep, TW, H]: shard k's output starts `stride` bytes after shard
// k - 1's.  The hop table (distance, byte offset, bytes) is built once per
// spec and row width by the wrapper and passed by address; the n_ep source
// pointers and the output's base travel in the kernel's parameters with
// it: no device allocation and no host-to-device copy per call, and the
// sources stay separate tensors, as each rank of a torch.distributed run
// will hold its own.  f32 and bf16 differ only in the row's bytes.
//
// Bound.  Bytes: each hop block read once and written once,
// 2 · n_ep · TW · H · elem over the card's memory rate; no arithmetic.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxShards = 32;
constexpr int kCopyThreads = 256;

struct Table {
  const char* src[kMaxShards];
  char* dst;                  // shard k's output at dst + k · stride
  long long stride;
  long long off[kMaxShards];  // byte offset of active hop i
  long long len[kMaxShards];  // bytes of active hop i
  int hop[kMaxShards];        // its distance h
};

__global__ void __launch_bounds__(kCopyThreads)
    exchange_kernel(Table t, int n, int inverse) {
  const int i = blockIdx.y, k = blockIdx.z, h = t.hop[i];
  const int to = inverse ? ((k - h) % n + n) % n : (k + h) % n;
  const char* s = t.src[k] + t.off[i];
  char* d = t.dst + to * t.stride + t.off[i];
  const long long nbytes = t.len[i];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d) |
        static_cast<uintptr_t>(nbytes)) & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(s);
    int4* d4 = reinterpret_cast<int4*>(d);
    for (long long q = first; q < nbytes / 16; q += stride) d4[q] = s4[q];
  } else {
    for (long long q = first; q < nbytes; q += stride) d[q] = s[q];
  }
}

}  // namespace

// One spec's hop table, built once by the wrapper (parallel/
// rdma_exchange.py::_HopTable has the same layout): n shards, n_active
// active hops, each of distance hop[i], byte offset off[i] and bytes
// len[i]; stride is the bytes of one shard's output (TW rows).
struct HopTable {
  int n, n_active;
  long long stride;
  int hop[kMaxShards];
  long long off[kMaxShards];
  long long len[kMaxShards];
};

// One launch: for each active hop i and each shard k, the block of srcs[k]
// goes to shard (k ± hop[i]) mod n of the output at dst.  srcs is a host
// array of n device pointers; rows of the output outside every active
// block are not written.
extern "C" int cgr_ring_exchange(const HopTable* ht, const void* const* srcs,
                                 void* dst, int inverse, void* stream) {
  const int n = ht->n, n_active = ht->n_active;
  if (n < 1 || n > kMaxShards || n_active < 0 || n_active >= kMaxShards)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_active == 0) return 0;
  Table t;
  long long longest = 0;
  for (int k = 0; k < n; ++k) t.src[k] = static_cast<const char*>(srcs[k]);
  t.dst = static_cast<char*>(dst);
  t.stride = ht->stride;
  for (int i = 0; i < n_active; ++i) {
    t.hop[i] = ht->hop[i];
    t.off[i] = ht->off[i];
    t.len[i] = ht->len[i];
    longest = t.len[i] > longest ? t.len[i] : longest;
  }
  // about four 16-byte chunks per thread for the longest block
  const long long per_block = 16LL * kCopyThreads * 4;
  long long bx = (longest + per_block - 1) / per_block;
  bx = bx < 1 ? 1 : (bx > 65535 ? 65535 : bx);
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(n_active),
                  static_cast<unsigned>(n));
  exchange_kernel<<<grid, kCopyThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(t, n, inverse);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
