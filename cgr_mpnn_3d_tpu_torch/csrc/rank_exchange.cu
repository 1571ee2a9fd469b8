// The hop exchange of edge partitioning across processes (CUDA C++, sm_90a):
// K12 with one EP shard a rank.
//
// Replaces the TPU kernel cgr_mpnn_3d_tpu/parallel/rdma_exchange.py::
// _exchange_call (_exchange_kernel :58) where the mesh's 'ep' axis spans
// processes.  Each of the n_ep ranks of an EP group holds its shard's wire
// buffer [TW, H]; hop h owns the rows [off_h, off_h + S_h) and moves them
// from shard k to shard k + h (inverse: k - h), mod n_ep:
//
//   out[(k ± h) mod n][off_h : off_h + S_h] = buf[k][off_h : off_h + S_h]
//
// the semantics of ring_exchange.cu and of ep_pack._rank_ring_move (the
// gloo version, which CPU tensors take) bit for bit.
//
// Design.  Every rank owns a region made by cudaMalloc (never torch's
// caching allocator, so that cudaIpcGetMemHandle names exactly it): two
// receive slots of TW rows, one per epoch parity, and the signal words.
// Each rank opens its peers' regions once (cudaIpcOpenMemHandle with
// cudaIpcMemLazyEnablePeerAccess: a process on the same card, or a peer
// card over NVLink).  The wrapper keeps an epoch counter per plan, the same
// on every rank, and passes it at each launch; exchange e uses slot e & 1.
// One block of kThreads runs it, with no host call that waits on a peer:
//
//   1. wait until each destination has read out this slot's previous use
//      (its released word in this rank's region reaches e - 2);
//   2. push each active hop block of this rank's buffer into the slot of
//      its destination, 16 bytes a store where aligned;
//   3. publish "hop i arrived at epoch e" in each destination's region, a
//      system-scope release after a system fence;
//   4. spin with system-scope acquire loads until each of this rank's own
//      sources has arrived at e;
//   5. copy its slot into the output the wrapper allocated (L2 loads: the
//      slot was written by another process);
//   6. mark the slot read out (released = e) in every peer's region.
//
// Steps 1 and 4 are the TPU kernel's two-way barrier with every peer a hop
// touches: the writer waits for its destination (1), the reader for its
// writer (4).  Both are needed when hops are asymmetric (caps (8, 0, 16)):
// a rank that only writes to a peer would otherwise run ahead of a peer
// still reading the slot, and the TPU kernel's docstring makes the same
// point.  Arrival words are kept per slot and hop: a writer of epoch e + 1
// may run before the writer of e has published, and the two must not share
// a word; a writer of e + 2 waits in step 1 until e was read out.
//
// Bounded spins.  Every spin reads %globaltimer and gives up after
// limit_ns (the wrapper passes the process group's timeout unless told
// otherwise).  On giving up the kernel writes an error code, the peer's
// shard and the epoch into mapped pinned host memory, which the wrapper
// reads without a device sync, and returns: a rank whose peer never
// arrives raises, and never hangs.
//
// Bound.  Bytes: each rank reads its TW rows and writes them into its
// peers, then reads its slot and writes its output: 2 · TW · H · elem over
// the card's memory rate, the one-card K12's count a shard.  At the main
// path's TW = 8, H = 400 that is 12.8 KB (f32), so latency decides: the
// signals' round trips, and, where two ranks share one card without MPS,
// the time slices between their contexts (a rank spins until its peer's
// context gets the card, about one slice, a cost that peers on separate
// cards do not pay).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxShards = 32;
constexpr int kThreads = 512;
constexpr long long kSlotAlign = 256;

// the signal words at the end of every region
struct Signals {
  unsigned arrived[2][kMaxShards];  // [slot][active hop]: last epoch landed
  unsigned released[kMaxShards];    // [peer shard]: last epoch it read out
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// until *word reaches `want` (epochs compared modulo 2^32); false past the
// limit
__device__ bool wait_for(const unsigned* word, unsigned want,
                         unsigned long long t0, unsigned long long limit) {
  while (static_cast<int>(load_acquire(word) - want) < 0) {
    if (now_ns() - t0 > limit) return false;
    __nanosleep(128);
  }
  return true;
}

}  // namespace

// One plan's table, built once by the wrapper (parallel/rdma_exchange.py::
// _RankTable has the same layout): n shards, this rank's shard me, n_active
// active hops, each of distance hop[i], byte offset off[i] and bytes len[i];
// every shard's region as mapped in this process (this rank's own at me);
// each region's slot s at s · slot_bytes, its Signals at sig_off; err the
// device address of the mapped host error words [code, peer, epoch, plan].
struct RankTable {
  int n, me, n_active, plan;
  long long slot_bytes, tw_bytes, sig_off;
  int hop[kMaxShards];
  long long off[kMaxShards];
  long long len[kMaxShards];
  char* region[kMaxShards];
  unsigned* err;
};

namespace {

__device__ __forceinline__ int dest(int k, int h, int n, int inverse) {
  return inverse ? ((k - h) % n + n) % n : (k + h) % n;
}

__device__ void fail(const RankTable& t, unsigned code, int peer,
                     unsigned epoch) {
  volatile unsigned* e = t.err;
  if (e[0] == 0) {
    e[1] = static_cast<unsigned>(peer);
    e[2] = epoch;
    e[3] = static_cast<unsigned>(t.plan);
    __threadfence_system();
    e[0] = code;
    __threadfence_system();
  }
}

// the block copies n bytes; `l2` loads bypass L1 (data another process
// wrote)
__device__ void copy_block(char* d, const char* s, long long n, bool l2) {
  if (((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d) |
        static_cast<uintptr_t>(n)) & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(s);
    int4* d4 = reinterpret_cast<int4*>(d);
    for (long long q = threadIdx.x; q < n / 16; q += blockDim.x)
      d4[q] = l2 ? __ldcg(s4 + q) : s4[q];
  } else {
    for (long long q = threadIdx.x; q < n; q += blockDim.x)
      d[q] = l2 ? __ldcg(s + q) : s[q];
  }
}

__global__ void __launch_bounds__(kThreads)
    rank_exchange_kernel(RankTable t, const char* src, char* out,
                         int inverse, unsigned epoch,
                         unsigned long long limit_ns) {
  __shared__ int failed;
  const int n = t.n, me = t.me, slot = epoch & 1;
  Signals* mine = reinterpret_cast<Signals*>(t.region[me] + t.sig_off);
  if (threadIdx.x == 0) {
    failed = 0;
    if (epoch > 2) {                                   // 1.
      const unsigned long long t0 = now_ns();
      for (int i = 0; i < t.n_active; ++i) {
        const int to = dest(me, t.hop[i], n, inverse);
        if (!wait_for(&mine->released[to], epoch - 2, t0, limit_ns)) {
          fail(t, 1, to, epoch);
          failed = 1;
          break;
        }
      }
      __threadfence_system();
    }
  }
  __syncthreads();
  if (failed) return;
  for (int i = 0; i < t.n_active; ++i) {               // 2.
    const int to = dest(me, t.hop[i], n, inverse);
    copy_block(t.region[to] + slot * t.slot_bytes + t.off[i], src + t.off[i],
               t.len[i], false);
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < t.n_active; ++i) {             // 3.
      Signals* theirs = reinterpret_cast<Signals*>(
          t.region[dest(me, t.hop[i], n, inverse)] + t.sig_off);
      store_release(&theirs->arrived[slot][i], epoch);
    }
    const unsigned long long t0 = now_ns();
    for (int i = 0; i < t.n_active; ++i) {             // 4.
      if (!wait_for(&mine->arrived[slot][i], epoch, t0, limit_ns)) {
        fail(t, 2, dest(me, t.hop[i], n, !inverse), epoch);
        failed = 1;
        break;
      }
    }
    __threadfence_system();
  }
  __syncthreads();
  if (failed) return;
  copy_block(out, t.region[me] + slot * t.slot_bytes, t.tw_bytes, true);  // 5.
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {                              // 6.
    for (int p = 0; p < n; ++p) {
      if (p == me) continue;
      Signals* theirs = reinterpret_cast<Signals*>(t.region[p] + t.sig_off);
      store_release(&theirs->released[me], epoch);
    }
  }
}

}  // namespace

// This rank's region for slots of slot_bytes (a multiple of kSlotAlign):
// slot 0, slot 1, then the Signals at 2 · slot_bytes; zeroed before it
// returns, with its IPC handle (64 bytes).
extern "C" int cgr_rank_region_create(long long slot_bytes, void** region,
                                      void* handle) {
  *region = nullptr;
  if (slot_bytes < 0 || slot_bytes % kSlotAlign)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = 2 * static_cast<size_t>(slot_bytes) + sizeof(Signals);
  cudaError_t err = cudaMalloc(region, bytes);
  if (err == cudaSuccess) err = cudaMemset(*region, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle),
                              *region);
  if (err != cudaSuccess && *region) {
    cudaFree(*region);
    *region = nullptr;
  }
  return static_cast<int>(err);
}

// A peer's region in this process, from its handle.
extern "C" int cgr_rank_region_open(const void* handle, void** peer) {
  cudaIpcMemHandle_t h;
  const char* b = static_cast<const char*>(handle);
  for (size_t i = 0; i < sizeof(h); ++i) h.reserved[i] = b[i];
  *peer = nullptr;
  return static_cast<int>(
      cudaIpcOpenMemHandle(peer, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int cgr_rank_region_close(void* peer) {
  return static_cast<int>(cudaIpcCloseMemHandle(peer));
}

extern "C" int cgr_rank_region_free(void* region) {
  return static_cast<int>(cudaFree(region));
}

// The process's four error words in mapped pinned host memory, made once:
// the host address (read by the wrapper without a sync) and the device one.
extern "C" int cgr_rank_errors(void** host, void** dev) {
  static unsigned* words = nullptr;
  if (!words) {
    cudaError_t err = cudaHostAlloc(reinterpret_cast<void**>(&words),
                                    4 * sizeof(unsigned),
                                    cudaHostAllocMapped);
    if (err != cudaSuccess) {
      words = nullptr;
      return static_cast<int>(err);
    }
    for (int i = 0; i < 4; ++i) words[i] = 0;
  }
  *host = words;
  return static_cast<int>(cudaHostGetDevicePointer(dev, words, 0));
}

// One exchange: this rank's buffer src [TW, H] out to its destinations,
// its sources' rows into out [TW, H], at epoch `epoch` (>= 1) of the plan.
extern "C" int cgr_rank_exchange(const RankTable* t, const void* src,
                                 void* out, int inverse, unsigned epoch,
                                 unsigned long long limit_ns, void* stream) {
  if (t->n < 2 || t->n > kMaxShards || t->me < 0 || t->me >= t->n ||
      t->n_active < 1 || t->n_active >= kMaxShards || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  rank_exchange_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *t, static_cast<const char*>(src), static_cast<char*>(out), inverse,
      epoch, limit_ns);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
