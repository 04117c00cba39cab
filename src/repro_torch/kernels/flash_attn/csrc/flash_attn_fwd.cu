// Kernel B8: forward softmax attention with GQA, causal and KV-length
// masks, by an online softmax over KV tiles.
//
// Replaces src/repro/kernels/flash_attn/kernel.py::flash_attention_pallas
// (body _kernel, kernel.py:29; pallas_call, kernel.py:117).  Same function:
//   o[b,h,i] = sum_j softmax_j(q[b,h,i]·scale · k[b,h//group,j]) v[b,h//group,j]
// over the keys j < kv_len[b] (and j <= i when causal); a row with no valid
// key is exactly 0.  Inputs q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D)
// contiguous, f32 or bf16; kv_len (B,) int32 with kv_len <= Skv (the
// wrapper, ops.py, clips it and pads Sq/Skv as the reference's ops.py does).
// The output has q's type.
//
// Design (the simple, right first version):
// * one block of 128 threads per (q tile of BQ=64 rows, query head, batch
//   row); it loops over the KV tiles of BK=64 keys in order and stops at the
//   last one with a valid key: at kv_len, and for a causal mask at the
//   block's last row, so tiles above the diagonal are never read;
// * q (pre-scaled, as kernel.py:50 scales q before the dot), the K and V
//   tiles and the tile of scores live in shared memory as f32; row strides
//   are padded by one float so a warp's rows fall in different banks;
// * the running max, normaliser and this tile's rescale factor per row sit
//   in shared memory, the output accumulator in f32 registers (each thread
//   holds 4 of the D columns in D/8 of the rows);
// * masked scores are -1e30 and their probabilities are set to exactly 0
//   after the exponential (kernel.py:59-68), so a row whose keys are all
//   masked so far keeps l == 0 and ends as 0 (kernel.py:82);
// * no fast math: expf and IEEE division.  The products run on the f32
//   pipe (FFMA), not the tensor cores.
//
// What bounds it on the H100: the work is 4·B·Hq·D·(valid pairs) FLOPs over
// bytes that are read about once (q, k, v, o), so operations bind: at the
// serving prefill (B=8, Hq=15, S=1960, D=64, causal) 59 GFLOP, 0.06 ms at
// the bf16 tensor-core peak, 0.88 ms on the f32 pipe this kernel uses.  This
// version is further held back by shared-memory loads (about 3 per 8 FFMA)
// and by recomputing nothing across q tiles: K/V tiles are re-read from L2
// by every q tile of a head.  The later redesign (wgmma on bf16 tiles, TMA
// into a ring of tiles, P·V in bf16) is where the tensor-core bound lies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int THREADS = 128;  // four warps
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory layout for head dim D (floats).
template <int D>
struct Layout {
  static constexpr int QS = D + 1;   // row stride of the q tile
  static constexpr int KS = D + 1;   // ... of the K tile
  static constexpr int VS = D;       // ... of the V tile (read along d)
  static constexpr int PS = BK + 1;  // ... of the score/probability tile
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * QS;
  static constexpr int V = K + BK * KS;
  static constexpr int P = V + BK * VS;
  static constexpr int M = P + BQ * PS;  // running max
  static constexpr int L = M + BQ;       // running normaliser
  static constexpr int A = L + BQ;       // this tile's rescale factor
  static constexpr int FLOATS = A + BQ;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ kv_len, T* __restrict__ out,
                          int Hq, int Hkv, int Sq, int Skv, int causal,
                          float scale) {
  static_assert(D % 4 == 0 && THREADS % (D / 4) == 0, "head dim");
  using Lay = Layout<D>;
  extern __shared__ float smem[];
  float* Qs = smem + Lay::Q;
  float* Ks = smem + Lay::K;
  float* Vs = smem + Lay::V;
  float* Ps = smem + Lay::P;
  float* m_s = smem + Lay::M;
  float* l_s = smem + Lay::L;
  float* a_s = smem + Lay::A;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);  // GQA: kv head = q head // group
  const int len = min(kv_len[b], Skv);

  const T* qb = q + (size_t)(b * Hq + h) * Sq * D;
  const T* kb = k + (size_t)(b * Hkv + hk) * Skv * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * Skv * D;
  T* ob = out + (size_t)(b * Hq + h) * Sq * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qs[r * Lay::QS + d] =
        q0 + r < Sq ? to_f(qb[(size_t)(q0 + r) * D + d]) * scale : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  // Score micro-tile of this thread: rows sr + 16·i, columns sc + 8·j.
  const int sr = tid / 8, sc = tid % 8;
  // Accumulator of this thread: rows tr + TR·i, columns tc + TC·j.
  constexpr int TC = D / 4;
  constexpr int TR = THREADS / TC;
  constexpr int RPT = BQ / TR;
  const int tc = tid % TC, tr = tid / TC;
  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int warp = tid / 32, lane = tid % 32;
  // Tiles from k_end on hold no valid key (all at or past kv_len, or, for a
  // causal mask, above every row of this block): skipping them is exact.
  const int k_end = causal ? min(len, q0 + BQ) : len;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Skv;
      const size_t g = (size_t)(k0 + r) * D + d;
      Ks[r * Lay::KS + d] = in ? to_f(kb[g]) : 0.f;
      Vs[r * Lay::VS + d] = in ? to_f(vb[g]) : 0.f;
    }
    __syncthreads();

    // s = (q·scale) k^T on this thread's 4 x 8 micro-tile.
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(sr + 16 * i) * Lay::QS + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) bk[j] = Ks[(sc + 8 * j) * Lay::KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = sr + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = sc + 8 * j, jk = k0 + c;
        const bool valid = jk < len && (!causal || jk <= q0 + r);
        Ps[r * Lay::PS + c] = valid ? s[i][j] : NEG_INF;
      }
    }
    __syncthreads();

    // Online softmax: warp w takes rows w, w+4, ...; lane the columns lane
    // and lane+32.
    for (int r = warp; r < BQ; r += THREADS / 32) {
      const int iq = q0 + r;
      const int j0 = k0 + lane, j1 = k0 + lane + 32;
      const bool v0 = j0 < len && (!causal || j0 <= iq);
      const bool v1 = j1 < len && (!causal || j1 <= iq);
      const float x0 = Ps[r * Lay::PS + lane];
      const float x1 = Ps[r * Lay::PS + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      // masked entries are exactly 0, also when m_new is still -1e30
      const float p0 = v0 ? expf(x0 - m_new) : 0.f;
      const float p1 = v1 ? expf(x1 - m_new) : 0.f;
      Ps[r * Lay::PS + lane] = p0;
      Ps[r * Lay::PS + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc · alpha + P V.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float alpha = a_s[tr + TR * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[c * Lay::VS + tc + TC * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(tr + TR * i) * Lay::PS + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // the normalisers are final (and set, if no tile ran)

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = tr + TR * i;
    if (q0 + r >= Sq) continue;
    const float l = l_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float o = l > 0.f ? acc[i][j] / fmaxf(l, 1e-30f) : 0.f;
      ob[(size_t)(q0 + r) * D + tc + TC * j] = from_f<T>(o);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, int B, int Hq, int Hkv,
                   int Sq, int Skv, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = Layout<D>::BYTES;
  auto kernel = flash_attn_fwd_kernel<T, D>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), Hq, Hkv, Sq, Skv, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* kv_len, void* out, int B, int Hq, int Hkv,
                     int Sq, int Skv, int causal, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Skv, causal,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Skv, causal,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Skv, causal,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Skv,
                            causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  dtype: 0 = f32, 1 = bf16.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* kv_len, void* out, int B, int Hq,
                              int Hkv, int Sq, int Skv, int D, int causal,
                              int dtype, float scale, void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(D, q, k, v, kv_len, out, B, Hq, Hkv, Sq, Skv,
                                causal, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(D, q, k, v, kv_len, out, B, Hq, Hkv,
                                        Sq, Skv, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
