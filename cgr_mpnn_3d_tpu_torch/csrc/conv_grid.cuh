// The D-MPNN conv layer as one cooperative grid per direction over the
// card (CUDA C++, sm_90a), shared by K6 and K8/K9 (fused_conv.cu, one
// layer) and K4 (conv_stack.cu, every layer through conv_layer and
// conv_layer_bwd); its tile, gathers, sums and grid are also the
// gather-linear's (gather_linear.cu: K5, K10/K11).  The TPU kernels do
// each direction of a layer in one pallas_call (pallas_fused.py::_fwd_call,
// _bwd_call, _fwd_call_r, _bwd_call_r); so does this header:
//
//   forward    messages: t = messages(h) [+ r at the senders], row ranges
//              (with bf16 products also W rounded to bf16)
//              | grid barrier |
//              product: tiles of t·W + b [+ skip·h0], act, dropout -> out
//              and/or pre (LayerEpi)
//   backward   recompute: t (and each row's scale); | | SiLU, GELU: the
//              pre-activation tiles
//              | | dpre: the 264 parts (kReduceBlocks) of dpre_kernel,
//              with dh0 = skip·dpre and the dskip partials
//              | | split-K partial tiles of dW = tᵀ·dpre, db's column
//              partials, the tiles of dt = dpre·Wᵀ
//              | | the sums of dW, db and dskip in partial order; dh, the
//              adjoint gather through edge_nbr_rev minus rev; K8/K9's dr
//              through node_out
//
// (K4 runs the backward from its own dpre: the last two phases.)  Items
// are dealt to the blocks at a fixed stride (fused_model_grid.cuh::items),
// every output element is written by one item, and no atomics are used:
// the result does not depend on the grid, and each output's arithmetic is
// that of the layered kernels it replaces (layered_common.cuh's gather,
// dpre, split-K and ordered sums; mma_tile's and mma_tile_bf16's product
// order), so the bits are theirs.  Data written in one phase and read in a
// later one goes through plain pointers or cp.async.cg (L2), never the
// non-coherent path.
//
// The tile.  A BMt x 64 output tile (BMt 64, or 32 when the 64-row tiles
// do not fill the SMs) of 256 threads, summed over one operand pair or
// two (TilePairs: the gather-linear's t1·Wa + xb·Wb, pair after pair
// through the same ring), its operands copied by cp.async
// 16-byte copies into a ring of kConvStages stages in dynamic shared
// memory: stage s + 1.. load while stage s computes.  A chunk that is not
// whole or not aligned is copied element by element (zeros outside the
// matrix).  f32: 16-deep stages, each thread sums 4 x 4 (2 x 4 at BMt 32)
// outputs over k ascending, one fmaf per k from 0, reading four k of an
// operand in one 16-byte shared load (8 FMAs a load at BMt 64).  bf16:
// 32-deep stages of bf16 operands (t, and W and dpre rounded to bf16 once
// in an earlier phase), fragments by ldmatrix (.trans for a k-major
// operand), mma.sync m16n8k16 per 16 k in ascending order.
//
// tools/conv_phases.py builds this with CGR_PHASE_CLOCK (thread 0 of
// block 0 stamps %globaltimer after each grid barrier, phase ids in the
// stamp's layer field: 1 messages, 2 pre-activation tiles, 3 bf16
// copies, 4 dpre, 5 products, 8 block 0's own product tiles, 9 the
// end), and with CGR_TILE_NO_LOAD or CGR_TILE_NO_FMA (the tile without its
// copies or without its products: probe builds, wrong results) to split
// the tile's time.  The shipped build carries none of them.

#pragma once

#include <cstdint>

#include "fused_model_grid.cuh"
#include "layered_common.cuh"

namespace cgr {

constexpr int kConvStages = 4;      // cp.async ring depth
constexpr int kConvHalf = 5120;     // bytes of one operand's stage
constexpr int kConvSmem = kConvStages * 2 * kConvHalf;  // dynamic smem
constexpr int kConvAlign = 128;     // the forward scratch's w16 offset, elements
constexpr int kConvChunk = kThreads;  // elements of a rounding or sum item

// The tile rows of a launch over `rows` rows whose widest product has N
// columns: 64, or 32 while the 64-row tiles do not fill the SMs
// (CGR_CONV_BM forces one).
inline int conv_bm(long long rows, int N, int sms) {
#ifdef CGR_CONV_BM
  return CGR_CONV_BM;
#else
  return ((rows + 63) / 64) * ((N + BN - 1) / BN) < sms ? 32 : 64;
#endif
}

// Blocks per SM: one (an SM to each tile) while the tiles of bm rows fit
// the SMs, else two (CGR_BLOCKS_PER_SM forces one of them).
inline int conv_blocks_per_sm(long long rows, int N, int bm, int sms) {
#ifdef CGR_BLOCKS_PER_SM
  return CGR_BLOCKS_PER_SM;
#else
  return ((rows + bm - 1) / bm) * ((N + BN - 1) / BN) <= sms ? 1 : 2;
#endif
}

// Where the forward's scratch holds W rounded to bf16 [Hin, H]: after t
// [rows, Hin], from the next multiple of kConvAlign elements (null at f32;
// ops/fused_conv.py::fwd_scratch_elems sizes the scratch).
template <bool kBf16>
inline Elem<kBf16>* conv_fwd_w16(Elem<kBf16>* scratch, long long rows,
                                 int Hin) {
  const long long at = (rows * Hin + kConvAlign - 1) / kConvAlign * kConvAlign;
  return kBf16 ? scratch + at : nullptr;
}

// The backward's buffers beside its states: dW's split-K partials [S, Hin,
// H] followed by db's [S, H]; with bf16 products W and dpre rounded to
// bf16.
template <bool kBf16>
struct ConvParts {
  float* wpart;
  Elem<kBf16> *w16, *dpre16;
};

template <bool kBf16>
ConvParts<kBf16> carve_parts(Carve& c, int S, long long rows, int Hin,
                             int H) {
  ConvParts<kBf16> q{};
  q.wpart = c.take<float>(static_cast<long long>(S) * (Hin + 1) * H);
  if (kBf16) {
    q.w16 = c.take<Elem<kBf16>>(static_cast<long long>(Hin) * H);
    q.dpre16 = c.take<Elem<kBf16>>(rows * H);
  }
  return q;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The four 8 x 8 b16 matrices whose rows this lane's address starts (lane
// 8i + r: row r of matrix i), as mma fragments; .trans transposes each.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

template <class T>
__device__ __forceinline__ bool whole_chunks(const T* p, long long ld) {
  return ld % (16 / sizeof(T)) == 0 &&
         (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Rows [r0, r0 + R) x columns [c0, c0 + C) of the row-major g (row stride
// ld; rows < nr and columns < nc exist, the rest reads 0) into s (row
// stride ss): a whole 16-byte chunk by cp.async when `vec`, any other
// element by element.
template <class T, int R, int C>
__device__ __forceinline__ void load_box(T* s, int ss, const T* g,
                                         long long ld, long long r0, int c0,
                                         long long nr, int nc, bool vec) {
  constexpr int V = 16 / sizeof(T), CH = C / V;
  for (int q = threadIdx.x; q < R * CH; q += kThreads) {
    const int rr = q / CH, cc = (q % CH) * V;
    const long long gr = r0 + rr;
    const int gc = c0 + cc;
    T* d = s + rr * ss + cc;
    if (vec && gr < nr && gc + V <= nc) {
      cp_async16(d, g + gr * ld + gc);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        d[e] = gr < nr && gc + e < nc ? g[gr * ld + gc + e] : from_f32<T>(0.f);
    }
  }
}

// One operand pair of a tile's product: Aop·Bop over K, where Aop(m, k) =
// A[m·lda + k] (TA: A[k·lda + m]) and Bop(k, n) = B[k·ldb + n] (TB:
// B[n·ldb + k]).  With a_padded, A's rows hold zeros from K (TA: from M)
// up to lda, so whole 16-byte copies may read up to lda.
template <class T>
struct TilePair {
  const T* A;
  long long lda;
  const T* B;
  long long ldb;
  int K;
  bool a_padded;
};

// The NP pairs of a tile, passed by value (one pair stays in registers).
template <class T, int NP>
struct TilePairs {
  TilePair<T> p[NP];
};

// The f32 BMt x 64 tile at (m0, n0) of the sum over the NP pairs of
// Aop·Bop, through epi(m, n, Σ), the pairs taken in order through one
// cp.async ring.  Thread (tx, ty) sums rows ty·RM + i and columns 4 tx + j
// (TB: tx + 16 j, which keeps its [n][k] stage reads free of bank
// conflicts), each over k ascending, one fmaf per k, each pair's K padded
// with zeros to a multiple of 16 -- mma_tile's order, pair by pair.
template <int BMt, bool TA, bool TB, int NP, class Epi>
__device__ void tile_f32(const TilePairs<float, NP> pp, int M, int N,
                         int m0, int n0, const Epi& epi, char* smem) {
  const TilePair<float>* p = pp.p;
  constexpr int BKf = 16, RM = BMt / 16, SK = BKf + 4;
  constexpr int SA = TA ? BMt : SK, SB = TB ? SK : BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  bool va[NP], vb[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q)
    va[q] = whole_chunks(p[q].A, p[q].lda), vb[q] = whole_chunks(p[q].B, p[q].ldb);
  const int nk0 = (p[0].K + BKf - 1) / BKf;
  const int nk = NP > 1 ? nk0 + (p[NP - 1].K + BKf - 1) / BKf : nk0;
  auto sa = [&](int s) {
    return reinterpret_cast<float*>(smem + 2 * s * kConvHalf);
  };
  auto sb = [&](int s) {
    return reinterpret_cast<float*>(smem + (2 * s + 1) * kConvHalf);
  };
  auto load = [&](int kb) {
    const bool second = NP > 1 && kb >= nk0;
    const TilePair<float>& q = p[second ? NP - 1 : 0];
    const bool qa = va[second ? NP - 1 : 0], qb = vb[second ? NP - 1 : 0];
    const int s = kb % kConvStages, k0 = (second ? kb - nk0 : kb) * BKf;
    const int ext = q.a_padded ? static_cast<int>(q.lda) : (TA ? M : q.K);
    if constexpr (TA)
      load_box<float, BKf, BMt>(sa(s), SA, q.A, q.lda, k0, m0, q.K, ext,
                                qa);
    else
      load_box<float, BMt, BKf>(sa(s), SA, q.A, q.lda, m0, k0, M, ext,
                                qa);
    if constexpr (TB)
      load_box<float, BN, BKf>(sb(s), SB, q.B, q.ldb, n0, k0, N, q.K,
                               qb);
    else
      load_box<float, BKf, BN>(sb(s), SB, q.B, q.ldb, k0, n0, q.K, N,
                               qb);
  };
  float acc[RM][4] = {};
#pragma unroll
  for (int kb = 0; kb < kConvStages - 1; ++kb) {
#ifndef CGR_TILE_NO_LOAD
    if (kb < nk) load(kb);
#endif
    cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait<kConvStages - 2>();
    __syncthreads();
#ifndef CGR_TILE_NO_LOAD
    if (kb + kConvStages - 1 < nk) load(kb + kConvStages - 1);
#endif
    cp_async_commit();
#ifdef CGR_TILE_NO_FMA
    continue;
#endif
    const float* a = sa(kb % kConvStages);
    const float* b = sb(kb % kConvStages);
#pragma unroll
    for (int kq = 0; kq < BKf; kq += 4) {
      float av[RM][4], bv[4][4];
      if constexpr (TA) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* r = a + (kq + kk) * SA + ty * RM;
          if constexpr (RM == 4) {
            const float4 v = *reinterpret_cast<const float4*>(r);
            av[0][kk] = v.x, av[1][kk] = v.y, av[2][kk] = v.z, av[3][kk] = v.w;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(r);
            av[0][kk] = v.x, av[1][kk] = v.y;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float4 v =
              *reinterpret_cast<const float4*>(a + (ty * RM + i) * SA + kq);
          av[i][0] = v.x, av[i][1] = v.y, av[i][2] = v.z, av[i][3] = v.w;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (TB) {  // q = j
          const float4 v =
              *reinterpret_cast<const float4*>(b + (tx + 16 * q) * SB + kq);
          bv[0][q] = v.x, bv[1][q] = v.y, bv[2][q] = v.z, bv[3][q] = v.w;
        } else {  // q = kk
          const float4 v =
              *reinterpret_cast<const float4*>(b + (kq + q) * SB + 4 * tx);
          bv[q][0] = v.x, bv[q][1] = v.y, bv[q][2] = v.z, bv[q][3] = v.w;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i][kk], bv[kk][j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the block's next tile
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty * RM + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + (TB ? tx + 16 * j : 4 * tx + j);
      if (m < M && n < N) epi(m, n, acc[i][j]);
    }
  }
}

// The bf16 twin: operands already bf16 (A [m][k] or, TA, [k][m]; B [k][n]
// or, TB, [n][k]), 32-deep stages; warp w sums rows 16 (w % WM) .. + 16
// and columns WC (w / WM) .. + WC of the tile as NT m16n8k16 tiles, each
// over k ascending in steps of 16, pair by pair (mma_tile_bf16's sequence).
template <int BMt, bool TA, bool TB, int NP, class Epi>
__device__ void tile_bf16(const TilePairs<__nv_bfloat16, NP> pp, int M,
                          int N, int m0, int n0, const Epi& epi, char* smem) {
  const TilePair<__nv_bfloat16>* p = pp.p;
  using T = __nv_bfloat16;
  constexpr int BKh = 32, WM = BMt / 16, WC = BN / (8 / WM), NT = WC / 8;
  constexpr int SA = TA ? BMt + 8 : BKh + 8, SB = TB ? BKh + 8 : BN + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = 16 * (warp % WM), wc = WC * (warp / WM);
  const int li = lane / 8, lr = lane % 8;
  bool va[NP], vb[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q)
    va[q] = whole_chunks(p[q].A, p[q].lda), vb[q] = whole_chunks(p[q].B, p[q].ldb);
  const int nk0 = (p[0].K + BKh - 1) / BKh;
  const int nk = NP > 1 ? nk0 + (p[NP - 1].K + BKh - 1) / BKh : nk0;
  auto sa = [&](int s) { return reinterpret_cast<T*>(smem + 2 * s * kConvHalf); };
  auto sb = [&](int s) {
    return reinterpret_cast<T*>(smem + (2 * s + 1) * kConvHalf);
  };
  auto load = [&](int kb) {
    const bool second = NP > 1 && kb >= nk0;
    const TilePair<T>& q = p[second ? NP - 1 : 0];
    const bool qa = va[second ? NP - 1 : 0], qb = vb[second ? NP - 1 : 0];
    const int s = kb % kConvStages, k0 = (second ? kb - nk0 : kb) * BKh;
    const int ext = q.a_padded ? static_cast<int>(q.lda) : (TA ? M : q.K);
    if constexpr (TA)
      load_box<T, BKh, BMt>(sa(s), SA, q.A, q.lda, k0, m0, q.K, ext,
                            qa);
    else
      load_box<T, BMt, BKh>(sa(s), SA, q.A, q.lda, m0, k0, M, ext,
                            qa);
    if constexpr (TB)
      load_box<T, BN, BKh>(sb(s), SB, q.B, q.ldb, n0, k0, N, q.K,
                           qb);
    else
      load_box<T, BKh, BN>(sb(s), SB, q.B, q.ldb, k0, n0, q.K, N,
                           qb);
  };
  float acc[NT][4] = {};
#pragma unroll
  for (int kb = 0; kb < kConvStages - 1; ++kb) {
#ifndef CGR_TILE_NO_LOAD
    if (kb < nk) load(kb);
#endif
    cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait<kConvStages - 2>();
    __syncthreads();
#ifndef CGR_TILE_NO_LOAD
    if (kb + kConvStages - 1 < nk) load(kb + kConvStages - 1);
#endif
    cp_async_commit();
#ifdef CGR_TILE_NO_FMA
    continue;
#endif
    const T* a = sa(kb % kConvStages);
    const T* b = sb(kb % kConvStages);
#pragma unroll
    for (int ks = 0; ks < BKh; ks += 16) {
      unsigned af[4];
      if constexpr (TA)
        ldsm_x4_t(af, a + (ks + lr + 8 * (li / 2)) * SA + wr + 8 * (li % 2));
      else
        ldsm_x4(af, a + (wr + lr + 8 * (li % 2)) * SA + ks + 8 * (li / 2));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned bf[4];
        if constexpr (TB)
          ldsm_x4(bf, b + (wc + 8 * (j + li / 2) + lr) * SB + ks + 8 * (li % 2));
        else
          ldsm_x4_t(bf,
                    b + (ks + lr + 8 * (li % 2)) * SB + wc + 8 * (j + li / 2));
        const unsigned b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
        mma_bf16_16816(acc[j], af, b0);
        mma_bf16_16816(acc[j + 1], af, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + wr + g + 8 * (q / 2);
      const int n = n0 + wc + 8 * j + 2 * t + q % 2;
      if (m < M && n < N) epi(m, n, acc[j][q]);
    }
}

// The tiles of an M x N product: ceil(M / BMt) x ceil(N / 64).
template <int BMt>
__host__ __device__ __forceinline__ int conv_tiles(long long M, int N) {
  return static_cast<int>((M + BMt - 1) / BMt) * ((N + BN - 1) / BN);
}

// Tile `tile` (row-major) of an M x N product of Elem operands, summed
// over the NP operand pairs in order.
template <bool kBf16, int BMt, bool TA, bool TB, int NP, class Epi>
__device__ __forceinline__ void conv_tile_pairs(
    const TilePairs<Elem<kBf16>, NP>& p, int M, int N, int tile,
    const Epi& epi, char* smem) {
  const int tn = (N + BN - 1) / BN;
  const int m0 = (tile / tn) * BMt, n0 = (tile % tn) * BN;
  if constexpr (kBf16)
    tile_bf16<BMt, TA, TB>(p, M, N, m0, n0, epi, smem);
  else
    tile_f32<BMt, TA, TB>(p, M, N, m0, n0, epi, smem);
}

// The tile of one operand pair.
template <bool kBf16, int BMt, bool TA, bool TB, class Epi>
__device__ __forceinline__ void conv_tile(const Elem<kBf16>* A, long long lda,
                                          const Elem<kBf16>* B, long long ldb,
                                          int M, int N, int K, int tile,
                                          const Epi& epi, char* smem) {
  const TilePairs<Elem<kBf16>, 1> p{{{A, lda, B, ldb, K, false}}};
  conv_tile_pairs<kBf16, BMt, TA, TB>(p, M, N, tile, epi, smem);
}

// Calls fn(part, j) for this block's items of a phase whose parts have
// n[0], n[1], ... items, taken in that order.
template <int P, class Fn>
__device__ __forceinline__ void phase_items(const int (&n)[P], Fn&& fn) {
  int total = 0;
#pragma unroll
  for (int k = 0; k < P; ++k) total += n[k];
  items(total, [&](int it) {
    int k = 0;
    while (it >= n[k]) it -= n[k++];
    fn(k, it);
  });
}

__host__ __device__ __forceinline__ int chunks_of(long long n) {
  return static_cast<int>((n + kConvChunk - 1) / kConvChunk);
}

// Four consecutive elements of a row of T from p (f32 as one 16-byte
// load, bf16 as one 8-byte load) as f32, and stored back as T.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x),
                       hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(lo), v[1] = __high2float(lo);
  v[2] = __low2float(hi), v[3] = __high2float(hi);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 x;
  *reinterpret_cast<__nv_bfloat162*>(&x.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&x.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = x;
}

// Elements c .. c + 3 of the row at p (n elements) as f32: one vector load
// with kVec, else the elements below n one by one (the rest read 0); and
// stored back as T (with kVec whole, else the elements below n).
template <bool kVec, class T>
__device__ __forceinline__ void load4_at(const T* p, int c, int n,
                                         float (&v)[4]) {
  if constexpr (kVec) {
    load4(p + c, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = c + e < n ? to_f32(p[c + e]) : 0.f;
  }
}

template <bool kVec, class T>
__device__ __forceinline__ void store4_at(T* p, int c, int n,
                                          const float (&v)[4]) {
  if constexpr (kVec) {
    store4(p + c, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < n) p[c + e] = from_f32<T>(v[e]);
  }
}

// Elements (r[u], c[u] .. c[u] + 3) of the gather-sum a for each live unit
// u of U: gather_elem's arithmetic, element by element (the entries in
// order), the row's indices read once a unit; at each entry the loads of
// every unit are issued before any is summed, so a thread keeps U rows in
// flight.  kVec: whole vector loads and stores; else element by element,
// columns from W on neither read nor stored.  Each row's scale goes to
// rscale from its unit at column 0.
template <bool kBf16, bool kVec, int U, class S, class O>
__device__ __forceinline__ void gather_units(const GatherArgs<S, O>& a,
                                             const int (&r)[U],
                                             const int (&c)[U],
                                             const bool (&live)[U]) {
  long long lo[U];
  float sum[U][4], v[U][4], s[U];
  int count[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    lo[u] = (static_cast<long long>(r[u]) / a.R) * a.C;
    count[u] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[u][e] = 0.f;
  }
  for (int d = 0; d < a.D; ++d) {
    long long j[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      j[u] = live[u] ? a.idx[static_cast<long long>(r[u]) * a.D + d] - lo[u]
                     : -1;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j[u] >= 0 && j[u] < a.C) {
        load4_at<kVec>(a.src + (lo[u] + j[u]) * a.W, c[u], a.W, v[u]);
        if (a.src_scale != nullptr)
          s[u] = operand<kBf16>(a.src_scale[lo[u] + j[u]]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j[u] >= 0 && j[u] < a.C) {
        ++count[u];
        if (a.src_scale == nullptr) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sum[u][e] = sum[u][e] + operand<kBf16>(v[u][e]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sum[u][e] = fmaf(s[u], operand<kBf16>(v[u][e]), sum[u][e]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!live[u]) continue;
    float scale = a.mean ? mean_colscale<kBf16>(count[u]) : 1.f;
    if (a.row_scale != nullptr) scale = operand<kBf16>(a.row_scale[r[u]]);
    if (a.mean || a.row_scale != nullptr)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[u][e] *= scale;
    if (a.extra != nullptr) {
      long long k = r[u];
      bool in = true;
      if (a.extra_idx != nullptr) {
        const long long elo =
            (static_cast<long long>(r[u]) / a.R) * a.extra_C;
        k = a.extra_idx[r[u]] - elo;
        in = k >= 0 && k < a.extra_C;
        k += elo;
      }
      if (in) {
        load4_at<kVec>(a.extra + k * a.W, c[u], a.W, v[u]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = a.extra_exact ? v[u][e] : operand<kBf16>(v[u][e]);
          sum[u][e] = a.row_scale == nullptr
                          ? sum[u][e] + x
                          : __fadd_rn(sum[u][e], __fmul_rn(scale, x));
        }
      }
    }
    if (a.sign != nullptr) {
      const long long j = a.sign[r[u]] - lo[u];
      if (j >= 0 && j < a.C) {
        load4_at<kVec>(a.src + (lo[u] + j) * a.W, c[u], a.W, v[u]);
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[u][e] -= operand<kBf16>(v[u][e]);
      }
    }
    store4_at<kVec>(a.out + r[u] * a.ld_out(), c[u], a.W, sum[u]);
    if (a.rscale != nullptr && c[u] == 0) a.rscale[r[u]] = scale;
  }
}

template <class T>
__device__ __forceinline__ bool aligned_as(const T* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Row item j (rows_per_item rows) of the gather-sum a (gather_elem's
// elements): four columns a thread where the rows allow vector loads; else
// one element a thread at a time, or with U > 1 U units of four columns a
// thread at once (gather_units, element loads).
template <bool kBf16, int U = 1, class S, class O>
__device__ __forceinline__ void gather_item(const GatherArgs<S, O>& a, int j,
                                            int rows_per) {
  int r0, r1;
  row_span(j, rows_per, static_cast<int>(a.rows), r0, r1);
  const bool quads = a.W % 4 == 0 && a.ld_out() % 4 == 0 &&
                     aligned_as(a.src, 4 * sizeof(S)) &&
                     aligned_as(a.out, 4 * sizeof(O)) &&
                     (a.extra == nullptr || aligned_as(a.extra, 16));
  if (quads) {
    const int q = a.W / 4;
    for (int i = threadIdx.x; i < (r1 - r0) * q; i += kThreads) {
      const int r[1] = {r0 + i / q}, c[1] = {(i % q) * 4};
      const bool live[1] = {true};
      gather_units<kBf16, true>(a, r, c, live);
    }
    return;
  }
  if constexpr (U == 1) {
    for (int i = threadIdx.x; i < (r1 - r0) * a.W; i += kThreads) {
      const int c = i % a.W;
      gather_elem<kBf16>(a, r0 + i / a.W, c, c == 0);
    }
  } else {
    const int q = (a.W + 3) / 4, n = (r1 - r0) * q;
    for (int i0 = threadIdx.x; i0 < n; i0 += U * kThreads) {
      int r[U], c[U];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * kThreads;
        live[u] = i < n;
        r[u] = r0 + (live[u] ? i / q : 0);
        c[u] = live[u] ? (i % q) * 4 : 0;
      }
      gather_units<kBf16, false>(a, r, c, live);
    }
  }
}

// Chunk j of dst = bf16(src) over n elements.
__device__ __forceinline__ void round_item(const float* src,
                                           __nv_bfloat16* dst, long long n,
                                           int j) {
  const long long end = (j + 1LL) * kConvChunk < n ? (j + 1LL) * kConvChunk : n;
  for (long long i = static_cast<long long>(j) * kConvChunk + threadIdx.x;
       i < end; i += kThreads)
    dst[i] = __float2bfloat16_rn(src[i]);
}

// Chunk j of out[i] = Σ_q part[q·G + i] over S partials, in order from 0
// (sum_splits_kernel's sum).
__device__ __forceinline__ void sum_item(const float* part, int S,
                                         long long G, float* out, int j) {
  const long long end = (j + 1LL) * kConvChunk < G ? (j + 1LL) * kConvChunk : G;
  for (long long i = static_cast<long long>(j) * kConvChunk + threadIdx.x;
       i < end; i += kThreads) {
    float s = 0.f;
    for (int q = 0; q < S; ++q) s += part[static_cast<size_t>(q) * G + i];
    out[i] = s;
  }
}

// An f32 operand as the product reads it: itself at f32, its bf16 copy
// at bf16.
template <bool kBf16>
__device__ __forceinline__ const Elem<kBf16>* weights(const float* w,
                                                      const Elem<kBf16>* w16) {
  if constexpr (kBf16)
    return w16;
  else
    return w;
}

// p at bf16, null at f32.
template <bool kBf16>
__device__ __forceinline__ __nv_bfloat16* bf16_only(Elem<kBf16>* p) {
  if constexpr (kBf16)
    return p;
  else
    return nullptr;
}

// ---------------------------------------------------------------- forward

template <bool kBf16, class O>
struct ConvFwdArgs {
  GatherArgs<Elem<kBf16>, Elem<kBf16>> msg;  // t = messages (and rscale)
  const float* w;                           // [Hin, H]
  Elem<kBf16>* w16;                         // bf16: w rounded (scratch)
  LayerEpi<Elem<kBf16>, O> epi;             // pre and/or out; neither: none
  int p, Hin, H;
};

template <bool kBf16, int BMt, class O>
__global__ void __launch_bounds__(kThreads, 2)
    conv_fwd_kernel(const ConvFwdArgs<kBf16, O> a) {
  extern __shared__ __align__(16) char smem[];
  CGR_STAMP(0, -1);
  const int rows = static_cast<int>(a.msg.rows), per = rows_per_item(a.p);
  const long long nw = static_cast<long long>(a.Hin) * a.H;
  const int n1[2] = {row_items(rows, per), kBf16 ? chunks_of(nw) : 0};
  phase_items(n1, [&](int k, int j) {
    if (k == 0)
      gather_item<kBf16>(a.msg, j, per);
    else if constexpr (kBf16)
      round_item(a.w, a.w16, nw, j);
  });
  if (a.epi.pre == nullptr && a.epi.out == nullptr) return;
  cooperative_groups::this_grid().sync();
  CGR_STAMP(1, 1);
  items(conv_tiles<BMt>(rows, a.H), [&](int it) {
    conv_tile<kBf16, BMt, false, false>(a.msg.out, a.Hin,
                                        weights<kBf16>(a.w, a.w16), a.H, rows,
                                        a.H, a.Hin, it, a.epi, smem);
  });
#ifdef CGR_PHASE_CLOCK
  __syncthreads();
  CGR_STAMP(1, 8);
  cooperative_groups::this_grid().sync();
  CGR_STAMP(1, 9);
#endif
}

// --------------------------------------------------------------- backward

template <bool kBf16, class O, class DH>
struct ConvBwdArgs {
  using E = Elem<kBf16>;
  // recompute (K6, K8/K9): t (and each row's scale) into msg.out; with
  // pre_epi.pre the pre-activation too
  int recompute;
  GatherArgs<E, E> msg;
  LayerEpi<E, E> pre_epi;
  // dpre (K6, K8/K9): dpre_kernel's arguments
  int dpre_on;
  const O *g, *out;
  const float* pre;
  const E* h0;
  E* dh0;
  const float* skip;
  const int* drop;
  int act, te;
  float* dpart;  // [kReduceBlocks] dskip partials
  // the products and sums
  const float* w;     // [Hin, H]
  const E* t;         // [rows, Hin]
  float* dpre;        // [rows, H]
  ConvParts<kBf16> parts;
  E* dt;              // [rows, Hin], null: no dt, dh or dr
  float *dw, *db, *dskip;
  GatherArgs<E, DH> dh;     // adjoint gather (dh.out null: none)
  GatherArgs<E, float> dr;  // K8/K9's dr through node_out (null: none)
  int p, Hin, H, S;
  long long rows;
};

template <bool kBf16, int BMt, class O, class DH>
__global__ void __launch_bounds__(kThreads, 2)
    conv_bwd_kernel(const ConvBwdArgs<kBf16, O, DH> a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float red[kThreads];
  CGR_STAMP(0, -1);
  using E = Elem<kBf16>;
  const cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int rows = static_cast<int>(a.rows), per = rows_per_item(a.p);
  const int Hin = a.Hin, H = a.H;
  const long long nw = static_cast<long long>(Hin) * H;
  const E* w = weights<kBf16>(a.w, a.parts.w16);
  if (a.recompute) {
    const int n1[2] = {row_items(rows, per), kBf16 ? chunks_of(nw) : 0};
    phase_items(n1, [&](int k, int j) {
      if (k == 0)
        gather_item<kBf16>(a.msg, j, per);
      else if constexpr (kBf16)
        round_item(a.w, a.parts.w16, nw, j);
    });
    grid.sync();
    CGR_STAMP(1, 1);
    if (a.pre_epi.pre != nullptr) {
      items(conv_tiles<BMt>(rows, H), [&](int it) {
        conv_tile<kBf16, BMt, false, false>(a.t, Hin, w, H, rows, H, Hin, it,
                                            a.pre_epi, smem);
      });
      grid.sync();
      CGR_STAMP(1, 2);
    }
  } else if constexpr (kBf16) {
    // K4: its dpre pass stored f32 only
    const int n1[2] = {chunks_of(nw), chunks_of(a.rows * H)};
    phase_items(n1, [&](int k, int j) {
      if (k == 0)
        round_item(a.w, a.parts.w16, nw, j);
      else
        round_item(a.dpre, a.parts.dpre16, a.rows * H, j);
    });
    grid.sync();
    CGR_STAMP(1, 3);
  }
  if (a.dpre_on) {
    items(kReduceBlocks, [&](int b) {
      dpre_part<O, E, E, O>(a.g, a.pre, a.out, a.dpre, a.h0, a.dh0, 0, a.skip,
                            a.drop, 1, 0, a.act, a.te, H, a.rows * H, a.dpart,
                            bf16_only<kBf16>(a.parts.dpre16), b,
                            kReduceBlocks, red);
    });
    grid.sync();
    CGR_STAMP(1, 4);
  }
  // dW's split-K partial tiles, dt's tiles, db's column partials
  const E* dp = weights<kBf16>(a.dpre, a.parts.dpre16);  // dpre as operand
  const long long chunk = (a.rows + a.S - 1) / a.S;
  const int tw = conv_tiles<BMt>(Hin, H), cb = (H + 255) / 256;
  float* cpart = a.parts.wpart + static_cast<size_t>(a.S) * Hin * H;
  const int n3[3] = {a.dw != nullptr ? a.S * tw : 0,
                     a.dt != nullptr ? conv_tiles<BMt>(rows, Hin) : 0,
                     a.db != nullptr ? a.S * cb : 0};
  phase_items(n3, [&](int k, int j) {
    if (k == 0) {
      const int s = j / tw;
      const long long k0 = s * chunk, left = a.rows - k0;
      const int kn = static_cast<int>(left < chunk ? (left > 0 ? left : 0)
                                                    : chunk);
      conv_tile<kBf16, BMt, true, false>(
          a.t + k0 * Hin, Hin, dp + k0 * H, H, Hin, H, kn, j % tw,
          StoreEpi{a.parts.wpart + static_cast<size_t>(s) * Hin * H, H},
          smem);
    } else if (k == 1) {
      conv_tile<kBf16, BMt, false, true>(dp, H, w, H, rows, Hin, H, j,
                                         StoreAs<E>{a.dt, Hin}, smem);
    } else {
      const int s = j / cb, c = (j % cb) * 256 + threadIdx.x;
      if (c < H) {
        const long long k0 = s * chunk;
        const long long k1 = k0 + chunk < a.rows ? k0 + chunk : a.rows;
        float v = 0.f;
        for (long long r = k0; r < k1; ++r) v += a.dpre[r * H + c];
        cpart[static_cast<size_t>(s) * H + c] = v;
      }
    }
  });
  grid.sync();
  CGR_STAMP(1, 5);
  // the ordered sums and the adjoint gathers
  const int n4[5] = {
      a.dw != nullptr ? chunks_of(nw) : 0, a.db != nullptr ? chunks_of(H) : 0,
      a.dskip != nullptr ? 1 : 0,
      a.dh.out != nullptr ? row_items(rows, per) : 0,
      a.dr.out != nullptr ? row_items(static_cast<int>(a.dr.rows), per) : 0};
  phase_items(n4, [&](int k, int j) {
    if (k == 0)
      sum_item(a.parts.wpart, a.S, nw, a.dw, j);
    else if (k == 1)
      sum_item(cpart, a.S, H, a.db, j);
    else if (k == 2)
      sum_item(a.dpart, kReduceBlocks, 1, a.dskip, j);
    else if (k == 3)
      gather_item<kBf16>(a.dh, j, per);
    else
      gather_item<kBf16>(a.dr, j, per);
  });
#ifdef CGR_PHASE_CLOCK
  grid.sync();
  CGR_STAMP(1, 9);
#endif
}

// ------------------------------------------------------------------ host

// The grid of a conv launch over `rows` rows whose widest product has N
// columns: the instantiation (fn32 or fn64 for 32- or 64-row tiles, by
// conv_bm), conv_blocks_per_sm of its blocks on each SM, or as many as fit
// at once if fewer do (the occupancy query, after raising the function's
// dynamic shared memory limit to kConvSmem, runs once per device and
// instantiation).  Returns 0 or a CUDA error code.
inline int conv_grid_of(const void* fn32, const void* fn64, long long rows,
                        int N, const void** fn, int* bm, int* grid,
                        int* per_sm, int* sms) {
  int fit = 0;
  const int err = occupancy_of(nullptr, 0, &fit, sms);
  if (err != 0) return err;
  *bm = conv_bm(rows, N, *sms);
  *fn = *bm == 32 ? fn32 : fn64;
  return grid_for(*fn, kConvSmem, conv_blocks_per_sm(rows, N, *bm, *sms),
                  grid, per_sm, sms);
}

template <class Args>
inline int launch_conv(const void* fn32, const void* fn64, long long rows,
                       int N, Args a, cudaStream_t st) {
  if (rows == 0) return 0;
  const void* fn = nullptr;
  int bm = 0, grid = 0, per_sm = 0, sms = 0;
  const int err = conv_grid_of(fn32, fn64, rows, N, &fn, &bm, &grid, &per_sm,
                               &sms);
  if (err != 0) return err;
  void* params[] = {&a};
  return launch_cooperative(fn, grid, kConvSmem, params, st);
}

template <bool kBf16, class O>
inline int launch_conv_fwd(const ConvFwdArgs<kBf16, O>& a, cudaStream_t st) {
  return launch_conv(
      reinterpret_cast<const void*>(&conv_fwd_kernel<kBf16, 32, O>),
      reinterpret_cast<const void*>(&conv_fwd_kernel<kBf16, 64, O>),
      a.msg.rows, a.H, a, st);
}

template <bool kBf16, class O, class DH>
inline int launch_conv_bwd(const ConvBwdArgs<kBf16, O, DH>& a,
                           cudaStream_t st) {
  return launch_conv(
      reinterpret_cast<const void*>(&conv_bwd_kernel<kBf16, 32, O, DH>),
      reinterpret_cast<const void*>(&conv_bwd_kernel<kBf16, 64, O, DH>),
      a.rows, a.Hin > a.H ? a.Hin : a.H, a, st);
}

// t = messages(h_in) [rows, Hin] (each row's scale to rscale when set),
// then drop_l(act(t·W + b + skip·h0)) with W [Hin, H] to `out` and the
// pre-activation to `pre`, each when set (neither: no product); out is O
// (the state type, or f32 for K6's linear pre-activations at bf16).  out
// may be h_in: the messages are complete before the product starts.  One
// cooperative launch; w16 is [Hin, H] of scratch at bf16 (null at f32).
// Returns 0 or a CUDA error code.
template <bool kBf16, class O = Elem<kBf16>>
inline int conv_layer(const ConvGraph& g, const Elem<kBf16>* h_in, int Hin,
                      const float* w, const float* b, const float* skip,
                      const Elem<kBf16>* h0, int H, int act, const int* drop,
                      int L, int l, Elem<kBf16>* t, Elem<kBf16>* w16,
                      float* pre, O* out, float* rscale, cudaStream_t st) {
  using E = Elem<kBf16>;
  ConvFwdArgs<kBf16, O> a{};
  a.msg = GatherArgs<E, E>{h_in, g.te, Hin, g.edge_nbr, g.D, g.rev, nullptr,
                           g.mean, g.te, g.rows, t, rscale};
  a.w = w;
  a.w16 = w16;
  a.epi = LayerEpi<E, O>{b, h0, skip, act, pre, out, H, drop, L, l, g.te};
  a.p = static_cast<int>(g.rows / g.te);
  a.Hin = Hin;
  a.H = H;
  return launch_conv_fwd(a, st);
}

// A conv layer's backward from dpre [rows, H]: dW = tᵀ·dpre and db = Σ_r
// dpre (split-K partials in parts.wpart, summed in split order), then dt
// = dpre·Wᵀ (stored as Elem: the operand the adjoint rounds) and dh = the
// messages' adjoint applied to dt: a gather through the transposed ELL
// array edge_nbr_rev, each entry scaled by its forward row's scale
// (rscale, for mean), minus the rev row, stored as DH.  A null output is
// skipped.  One cooperative launch (at bf16 first rounding W and dpre into
// parts).  Returns 0 or a CUDA error code.
template <bool kBf16, class DH>
inline int conv_layer_bwd(const ConvGraph& g, const int* edge_nbr_rev,
                          const Elem<kBf16>* t, int Hin, float* dpre, int H,
                          const float* w, const float* rscale, int S,
                          const ConvParts<kBf16>& parts, Elem<kBf16>* dt,
                          DH* dh, float* dw, float* db, cudaStream_t st) {
  using E = Elem<kBf16>;
  ConvBwdArgs<kBf16, E, DH> a{};
  a.w = w;
  a.t = t;
  a.dpre = dpre;
  a.parts = parts;
  a.dt = dh != nullptr ? dt : nullptr;
  a.dw = dw;
  a.db = db;
  a.dh = GatherArgs<E, DH>{dt, g.te, Hin, edge_nbr_rev, g.D, g.rev,
                           g.mean ? rscale : nullptr, 0, g.te, g.rows, dh,
                           nullptr};
  a.p = static_cast<int>(g.rows / g.te);
  a.Hin = Hin;
  a.H = H;
  a.S = S;
  a.rows = g.rows;
  return launch_conv_bwd(a, st);
}

}  // namespace cgr
