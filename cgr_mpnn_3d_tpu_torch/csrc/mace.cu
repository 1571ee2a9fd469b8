// MACE-MP-0 descriptors (CUDA C++, sm_90a): the interaction and product
// kernels of one layer (wrappers ops/mace.py, equations models/mace.py).
//
// They replace no TPU kernel: the JAX package took MACE descriptors from the
// mace-torch package on the host.  Both run in float32 on the CUDA cores.
//
// interaction_kernel, one block a structure, one thread a channel (C = 128):
// the block walks the structure's ordered atom pairs receiver-major in
// chunks of blockDim pairs, keeps those within r_max (a ballot and a warp
// prefix, so the edge order and every sum's order are fixed), and takes the
// kept edges kEC at a time: the spherical harmonics and the Bessel functions
// under the envelope (kEC threads), the three hidden layers of the radial
// MLP (weights in shared memory), then per thread the last layer's four
// outputs of its channel for the kEC edges in registers, multiplied at once
// with the sender's up-projected feature and Y_lm and added into the
// receiver's 16 sums (registers, written once when the receiver changes).
// The [edges, 4C] radial weights never reach memory.  Bound: operations,
// 2(NB RH + 2 RH^2 + 4 C RH) + 3 * 16 C an edge (~84 kFLOP at the published
// widths), against 67 TFLOP/s; the last layer's weights stream from L2
// once a chunk.
//
// product_kernel, one block a tile of kTile atoms of one element
// (ops.mace.element_tiles), one thread a channel: the message maps a l
// (element-dependent at layer 0, the skip folded in), the symmetric
// contraction as ops.mace's polynomials of the 16 A's of the thread's
// channel, the element's folded weights, the output map plus the residual,
// written into the descriptor array's columns of the layer, and for the
// next layer its up-projection and element-dependent residual map.  The
// tile shares each weight load among its kTile atoms.  Bound: operations,
// 2 * 16 C^2 + ~3 * 94 C + 2 Q C + 2 C^2 (+ 4 C^2 with a next layer) an atom.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEC = 16;    // edges a chunk
constexpr int kLM = 16;    // spherical-harmonic components, l <= 3
constexpr int kTile = 4;   // atoms a product block (ops.mace.TILE)
constexpr float kPi = 3.14159265358979323846f;

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

// models.mace.real_sh of the unit vector (x, y, z)
__device__ __forceinline__ void sph16(float x, float y, float z, float* Y) {
  const float X = z, Yc = x, Z = y;
  const float s3 = 1.7320508075688772f, s5 = 2.23606797749979f;
  const float s15 = s5 * s3;
  Y[0] = 1.0f;
  Y[1] = s3 * Yc;
  Y[2] = s3 * Z;
  Y[3] = s3 * X;
  Y[4] = s15 * X * Yc;
  Y[5] = s15 * Yc * Z;
  Y[6] = s5 * 0.5f * (3.0f * Z * Z - 1.0f);
  Y[7] = s15 * X * Z;
  Y[8] = s15 * 0.5f * (X * X - Yc * Yc);
  Y[9] = 2.0916500663351889f * Yc * (3.0f * X * X - Yc * Yc);
  Y[10] = 10.246950765959598f * X * Yc * Z;
  Y[11] = 1.6201851746019651f * Yc * (5.0f * Z * Z - 1.0f);
  Y[12] = 1.3228756555322954f * Z * (5.0f * Z * Z - 3.0f);
  Y[13] = 1.6201851746019651f * X * (5.0f * Z * Z - 1.0f);
  Y[14] = 5.1234753829797990f * Z * (X * X - Yc * Yc);
  Y[15] = 2.0916500663351889f * X * (X * X - 3.0f * Yc * Yc);
}

// out[e][u] = silu(sum_k in[e][k] w[k][u]) for kEC rows
__device__ __forceinline__ void dense_silu(const float* in, int K,
                                           const float* w, float* out, int N) {
  for (int idx = threadIdx.x; idx < kEC * N; idx += blockDim.x) {
    const int e = idx / N, u = idx - e * N;
    const float* x = in + e * K;
    float s = 0.0f;
    for (int k = 0; k < K; ++k) s += x[k] * w[k * N + u];
    out[e * N + u] = silu(s);
  }
}

__global__ void interaction_kernel(
    const float* __restrict__ pos, const int* __restrict__ sptr,
    const float* __restrict__ hup, const float* __restrict__ w1,
    const float* __restrict__ w2, const float* __restrict__ w3,
    const float* __restrict__ w4, float* __restrict__ msg, int C, int NB,
    int RH, float r_max, int p) {
  extern __shared__ float smem[];
  float* sw1 = smem;
  float* sw2 = sw1 + NB * RH;
  float* sw3 = sw2 + RH * RH;
  float* srb = sw3 + RH * RH;
  float* sy = srb + kEC * NB;
  float* sha = sy + kEC * kLM;
  float* shb = sha + kEC * RH;
  int* slist = reinterpret_cast<int*>(shb + kEC * RH);
  int* srecv = slist + blockDim.x;
  int* ssend = srecv + kEC;
  int* swarp = ssend + kEC;

  const int tid = threadIdx.x, bd = blockDim.x, c = tid;
  const int lane = tid & 31, warp = tid >> 5, nwarps = bd >> 5;
  const int base = sptr[blockIdx.x];
  const int n = sptr[blockIdx.x + 1] - base;
  for (int i = tid; i < NB * RH; i += bd) sw1[i] = w1[i];
  for (int i = tid; i < RH * RH; i += bd) {
    sw2[i] = w2[i];
    sw3[i] = w3[i];
  }
  const float r2max = r_max * r_max;
  const float pre0 = sqrtf(2.0f / r_max);
  const float fp = static_cast<float>(p);
  const float c1 = 0.5f * (fp + 1.0f) * (fp + 2.0f), c2 = fp * (fp + 2.0f),
              c3 = 0.5f * fp * (fp + 1.0f);

  float acc[kLM];
#pragma unroll
  for (int k = 0; k < kLM; ++k) acc[k] = 0.0f;
  int cur = -1;
  const long long NN = static_cast<long long>(n) * n;

  for (long long q0 = 0; q0 < NN; q0 += bd) {
    const long long q = q0 + tid;
    bool valid = false;
    if (q < NN) {
      const int i = static_cast<int>(q / n), j = static_cast<int>(q % n);
      if (i != j) {
        const float* pi = pos + 3 * (base + i);
        const float* pj = pos + 3 * (base + j);
        const float dx = pi[0] - pj[0], dy = pi[1] - pj[1],
                    dz = pi[2] - pj[2];
        valid = dx * dx + dy * dy + dz * dz < r2max;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) swarp[warp] = __popc(ballot);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int cnt = swarp[w];
      if (w < warp) off += cnt;
      total += cnt;
    }
    if (valid)
      slist[off + __popc(ballot & ((1u << lane) - 1u))] =
          static_cast<int>(q - q0);
    __syncthreads();

    for (int e0 = 0; e0 < total; e0 += kEC) {
      const int ne = min(kEC, total - e0);
      if (tid < kEC) {
        float* rb = srb + tid * NB;
        float* yy = sy + tid * kLM;
        if (tid < ne) {
          const long long qq = q0 + slist[e0 + tid];
          const int i = static_cast<int>(qq / n), j = static_cast<int>(qq % n);
          const float* pi = pos + 3 * (base + i);
          const float* pj = pos + 3 * (base + j);
          const float dx = pi[0] - pj[0], dy = pi[1] - pj[1],
                      dz = pi[2] - pj[2];
          const float r = sqrtf(dx * dx + dy * dy + dz * dz);
          const float inv = 1.0f / r;
          sph16(dx * inv, dy * inv, dz * inv, yy);
          const float x = r / r_max;
          float env = 0.0f;
          if (x < 1.0f) {
            float xp = 1.0f;
            for (int k = 0; k < p; ++k) xp *= x;
            env = 1.0f - c1 * xp + c2 * xp * x - c3 * xp * x * x;
          }
          const float pre = pre0 * env * inv;
          for (int k = 0; k < NB; ++k)
            rb[k] = pre * sinf(static_cast<float>(k + 1) * (kPi / r_max) * r);
          srecv[tid] = i;
          ssend[tid] = j;
        } else {
          for (int k = 0; k < NB; ++k) rb[k] = 0.0f;
          for (int k = 0; k < kLM; ++k) yy[k] = 0.0f;
          srecv[tid] = -1;
          ssend[tid] = 0;
        }
      }
      __syncthreads();
      dense_silu(srb, NB, sw1, sha, RH);
      __syncthreads();
      dense_silu(sha, RH, sw2, shb, RH);
      __syncthreads();
      dense_silu(shb, RH, sw3, sha, RH);
      __syncthreads();

      float R[kEC][4];
#pragma unroll
      for (int e = 0; e < kEC; ++e)
#pragma unroll
        for (int l = 0; l < 4; ++l) R[e][l] = 0.0f;
      for (int k = 0; k < RH; ++k) {
        const float* wk = w4 + static_cast<size_t>(k) * 4 * C + c;
        const float a0 = __ldg(wk), a1 = __ldg(wk + C), a2 = __ldg(wk + 2 * C),
                    a3 = __ldg(wk + 3 * C);
#pragma unroll
        for (int e = 0; e < kEC; ++e) {
          const float h = sha[e * RH + k];
          R[e][0] += h * a0;
          R[e][1] += h * a1;
          R[e][2] += h * a2;
          R[e][3] += h * a3;
        }
      }
#pragma unroll
      for (int e = 0; e < kEC; ++e) {
        if (e < ne) {
          const int rcv = srecv[e];
          if (rcv != cur) {
            if (cur >= 0) {
              float* dst = msg + static_cast<size_t>(base + cur) * kLM * C + c;
#pragma unroll
              for (int k = 0; k < kLM; ++k) dst[k * C] = acc[k];
            }
#pragma unroll
            for (int k = 0; k < kLM; ++k) acc[k] = 0.0f;
            cur = rcv;
          }
          const float hj = hup[static_cast<size_t>(base + ssend[e]) * C + c];
          const float* yy = sy + e * kLM;
          const float r0 = R[e][0] * hj, r1 = R[e][1] * hj,
                      r2 = R[e][2] * hj, r3 = R[e][3] * hj;
          acc[0] += r0 * yy[0];
#pragma unroll
          for (int k = 1; k < 4; ++k) acc[k] += r1 * yy[k];
#pragma unroll
          for (int k = 4; k < 9; ++k) acc[k] += r2 * yy[k];
#pragma unroll
          for (int k = 9; k < 16; ++k) acc[k] += r3 * yy[k];
        }
      }
      __syncthreads();
    }
    __syncthreads();
  }
  if (cur >= 0) {
    float* dst = msg + static_cast<size_t>(base + cur) * kLM * C + c;
#pragma unroll
    for (int k = 0; k < kLM; ++k) dst[k * C] = acc[k];
  }
}

__global__ void product_kernel(
    const float* __restrict__ msg, const int* __restrict__ z,
    const int* __restrict__ tiles, const float* __restrict__ m,
    long long m_es, const float* __restrict__ weff,
    const int* __restrict__ mono, const float* __restrict__ coef,
    const int* __restrict__ pptr, int Q, const float* __restrict__ wout,
    const float* __restrict__ sc, float* __restrict__ out, int out_stride,
    int out_col, const float* __restrict__ wup,
    const float* __restrict__ wskip, float* __restrict__ hup_out,
    float* __restrict__ sc_out, int C) {
  extern __shared__ float smem[];
  float* sa = smem;                       // [kTile][17][C]
  float* sb = sa + kTile * (kLM + 1) * C;  // [kTile][C]
  const int c = threadIdx.x;
  int atom[kTile];
#pragma unroll
  for (int k = 0; k < kTile; ++k)
    atom[k] = tiles[static_cast<size_t>(blockIdx.x) * kTile + k];
  const int el = z[atom[0]];
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    const float* src =
        msg + static_cast<size_t>(atom[k] >= 0 ? atom[k] : 0) * kLM * C + c;
    for (int lm = 0; lm < kLM; ++lm)
      sa[(k * (kLM + 1) + lm) * C + c] = atom[k] >= 0 ? src[lm * C] : 0.0f;
    sa[(k * (kLM + 1) + kLM) * C + c] = 1.0f;
  }
  __syncthreads();

  // A = msg @ m[el, l]
  float acc[kTile][kLM];
#pragma unroll
  for (int k = 0; k < kTile; ++k)
#pragma unroll
    for (int lm = 0; lm < kLM; ++lm) acc[k][lm] = 0.0f;
  const float* me = m + static_cast<size_t>(el) * m_es;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const float* ml = me + static_cast<size_t>(l) * C * C + c;
    for (int ci = 0; ci < C; ++ci) {
      const float w = __ldg(ml + static_cast<size_t>(ci) * C);
#pragma unroll
      for (int k = 0; k < kTile; ++k)
#pragma unroll
        for (int mm = 0; mm < 2 * l + 1; ++mm)
          acc[k][l * l + mm] += sa[(k * (kLM + 1) + l * l + mm) * C + ci] * w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kTile; ++k)
#pragma unroll
    for (int lm = 0; lm < kLM; ++lm)
      sa[(k * (kLM + 1) + lm) * C + c] = acc[k][lm];
  // each thread reads back only its own channel's A below

  const float* we = weff + static_cast<size_t>(el) * Q * C + c;
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    const float* ak = sa + k * (kLM + 1) * C + c;
    float B = 0.0f;
    for (int q = 0; q < Q; ++q) {
      float phi = 0.0f;
      for (int t = pptr[q]; t < pptr[q + 1]; ++t) {
        const int mo = mono[t];
        phi += coef[t] * ak[(mo & 255) * C] * ak[((mo >> 8) & 255) * C] *
               ak[((mo >> 16) & 255) * C];
      }
      B += we[static_cast<size_t>(q) * C] * phi;
    }
    sb[k * C + c] = B;
  }
  __syncthreads();

  float h[kTile];
#pragma unroll
  for (int k = 0; k < kTile; ++k) h[k] = 0.0f;
  for (int ci = 0; ci < C; ++ci) {
    const float w = __ldg(wout + static_cast<size_t>(ci) * C + c);
#pragma unroll
    for (int k = 0; k < kTile; ++k) h[k] += sb[k * C + ci] * w;
  }
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    if (atom[k] < 0) continue;
    if (sc != nullptr) h[k] += sc[static_cast<size_t>(atom[k]) * C + c];
    out[static_cast<size_t>(atom[k]) * out_stride + out_col + c] = h[k];
  }
  if (wup == nullptr) return;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kTile; ++k) sb[k * C + c] = h[k];
  __syncthreads();
  float u[kTile], v[kTile];
#pragma unroll
  for (int k = 0; k < kTile; ++k) u[k] = v[k] = 0.0f;
  const float* ws = wskip + static_cast<size_t>(el) * C * C + c;
  for (int ci = 0; ci < C; ++ci) {
    const float a = __ldg(wup + static_cast<size_t>(ci) * C + c);
    const float b = __ldg(ws + static_cast<size_t>(ci) * C);
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      u[k] += sb[k * C + ci] * a;
      v[k] += sb[k * C + ci] * b;
    }
  }
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    if (atom[k] < 0) continue;
    hup_out[static_cast<size_t>(atom[k]) * C + c] = u[k];
    sc_out[static_cast<size_t>(atom[k]) * C + c] = v[k];
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace

// msg [A, 16, C] (zeroed by the caller) = every structure's messages;
// S structures of atoms sptr[s]..sptr[s + 1]; C threads a block.
extern "C" int cgr_mace_interaction(const float* pos, const int* sptr,
                                    const float* hup, const float* w1,
                                    const float* w2, const float* w3,
                                    const float* w4, float* msg, int S, int C,
                                    int NB, int RH, float r_max, int p,
                                    void* stream) {
  if (C % 32 != 0 || C > 1024 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      sizeof(float) * (NB * RH + 2 * RH * RH + kEC * NB + kEC * kLM +
                       2 * kEC * RH) +
      sizeof(int) * (C + 2 * kEC + 32);
  const int err = set_smem(reinterpret_cast<const void*>(interaction_kernel),
                           bytes);
  if (err != 0) return err;
  interaction_kernel<<<S, C, bytes, static_cast<cudaStream_t>(stream)>>>(
      pos, sptr, hup, w1, w2, w3, w4, msg, C, NB, RH, r_max, p);
  return static_cast<int>(cudaGetLastError());
}

// One layer's product over T tiles of kTile atoms (tiles [T, kTile], -1
// padding, one element a tile): out[a * out_stride + out_col + c] = h; with
// wup, hup_out = h @ wup and sc_out = h @ wskip[z].
extern "C" int cgr_mace_product(const float* msg, const int* z,
                                const int* tiles, const float* m,
                                const float* weff, const int* mono,
                                const float* coef, const int* pptr,
                                const float* wout, const float* sc, float* out,
                                const float* wup, const float* wskip,
                                float* hup_out, float* sc_out, int T, int C,
                                int Q, int out_stride, int out_col,
                                long long m_es, void* stream) {
  if (C % 32 != 0 || C > 1024 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(float) * (kTile * (kLM + 1) * C + kTile * C);
  const int err = set_smem(reinterpret_cast<const void*>(product_kernel),
                           bytes);
  if (err != 0) return err;
  product_kernel<<<T, C, bytes, static_cast<cudaStream_t>(stream)>>>(
      msg, z, tiles, m, m_es, weff, mono, coef, pptr, Q, wout, sc, out,
      out_stride, out_col, wup, wskip, hup_out, sc_out, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cgr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
