// Dense SNP transition step for Hopper (sm_90a), bound with ctypes:
// kernels B1 (one device) and B6 (one neuron shard).
//
// Replaces the bodies of the TPU kernel
// src/repro/kernels/snp_step/kernel.py::snp_step_pallas without delays:
// _make_kernel(has_halo=False) (B1) and _make_kernel(has_halo=True) (B6,
// wrapper ops.py::snp_step_dense_shard), here one template with the halo
// as a flag.  For every config b and branch id t < T it computes
//
//   S[b,t,i]   = app[b,i] && (t / stride[b,mu(i)]) % choices[b,mu(i)] == rank[b,i]
//   out[b,t,:] = C[b,:] + sum_i S[b,t,i] * M[i,:]
//   emis[b,t]  = sum_i S[b,t,i] * env[i]                       (B1 only)
//   valid[b,t] = (float)t < psi[b]                             (B1 only)
//
// with mu(i) = rule_neuron[i].  The shard body (HAS_HALO) adds the remote
// produce the halo exchange delivered, over the 0/1 halo in-adjacency:
//
//   out[b,t,:] += sum_s halo[b,t,s] * hadj[s,:]                (B6)
//
// and writes neither emissions nor validity (the sharded explore judges
// those).  The spiking vector S never reaches device memory: it is
// decoded from t inside the block.  Sums are int32, so they are exact
// wherever the reference's f32 sums are (|values| < 2^24): the TPU body's
// f32 halo product is exact too, its halo values being fired produce
// (< 2^16) and hadj 0/1.
//
// What bounds it.  Per call it must write B*T*m*4 output bytes and reads
// far less (M is n*m*4 bytes, read once at best).  The operations the
// data needs are few: at most one rule fires per neuron, and a fired
// rule adds only the nonzeros of its row of M (1 + out-degree); a halo
// slot adds only its column's nonzeros.  At the full-width explore wave
// (B=512, T=64, n=3410, m=2046) that is 268 MB of output against about
// 0.4 G operations, so bytes bind (about 0.09 ms); the dense contraction
// would be 2*B*T*n*m = 457 G.  At a shard of scaled_pi(682) over four
// shards (nloc=853, mloc=512, 8 halo slots) bytes bind too: 67 MB out.
//
// What the design does about it.  A block owns one config b, BT=32 branch
// ids and BM=128 output columns, and walks the rule axis in tiles of
// BK=32 rules: it decodes S for the tile into shared memory once (reused
// by all 128 columns), stages the M tile in shared memory (reused by all
// 32 branches), and each thread keeps a 4x4 int32 tile of sums in
// registers.  The shard body extends the rule axis by the H halo slots:
// their "S" rows are the halo values and their "M" rows are hadj, so the
// halo term rides the same tiles.  The ragged edges of B, T, n, H and m
// are masked in the kernel; nothing is padded.  The work stays dense:
// this kernel does all 2*B*T*(n+H)*m operations on the int32 datapath (no
// tensor cores), although S, M and hadj are mostly zeros, so it runs far
// above the byte bound.  Skipping all-zero tiles of M and rules that did
// not fire, int8 tensor-core products (|M| <= 127) and TMA staging are
// later work.
//
// Determinism: no atomics; every output is written by exactly one thread.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BT = 32;                // branch ids per block
constexpr int BM = 128;               // output columns (neurons) per block
constexpr int BK = 32;                // rules per shared-memory tile
constexpr int THREADS = 256;          // 8 warps
constexpr int RT = BT / (THREADS / 32);  // branches per thread (4)
constexpr int RM = BM / 32;           // columns per thread (4)

template <bool HAS_HALO>
__global__ void __launch_bounds__(THREADS)
snp_step_dense_kernel(const int* __restrict__ configs,
                      const int* __restrict__ rank,
                      const unsigned char* __restrict__ app,
                      const int* __restrict__ stride,
                      const int* __restrict__ choices,
                      const float* __restrict__ psi,
                      const int* __restrict__ rule_neuron,
                      const int* __restrict__ M,
                      const int* __restrict__ env,
                      const signed char* __restrict__ hadj,
                      const int* __restrict__ halo,
                      int* __restrict__ out,
                      unsigned char* __restrict__ valid,
                      int* __restrict__ emis,
                      int T, int n, int m, int H, int m_tiles,
                      int t_tiles) {
  __shared__ int s_tile[BK][BT];   // decoded S of the rule tile, rule-major
  __shared__ int m_tile[BK][BM];   // rows of M for the rule tile
  __shared__ int r_stride[BK], r_choices[BK], r_rank[BK], r_env[BK];
  __shared__ int r_app[BK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;       // column lane
  const int warp = tid >> 5;       // branch row
  unsigned blk = blockIdx.x;
  const int mt = blk % m_tiles;
  blk /= m_tiles;
  const int tt = blk % t_tiles;
  const int b = blk / t_tiles;
  const int t0 = tt * BT;
  const int m0 = mt * BM;
  const bool first_cols = !HAS_HALO && (mt == 0);
  const int n_all = HAS_HALO ? n + H : n;   // rules, then halo slots

  const int* rank_b = rank + (size_t)b * n;
  const unsigned char* app_b = app + (size_t)b * n;
  const int* stride_b = stride + (size_t)b * m;
  const int* choices_b = choices + (size_t)b * m;

  int acc[RT][RM];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < RM; ++c) acc[r][c] = 0;
  int e_acc = 0;  // emission of branch t0 + tid (first warp, column tile 0)

  for (int k0 = 0; k0 < n_all; k0 += BK) {
    // 1. this tile's per-rule decode parameters for config b
    if (tid < BK) {
      const int k = k0 + tid;
      const bool in = k < n;
      const int mu = in ? rule_neuron[k] : 0;
      r_app[tid] = in ? app_b[k] : 0;
      r_rank[tid] = in ? rank_b[k] : -1;
      r_stride[tid] = in ? stride_b[mu] : 1;
      r_choices[tid] = in ? choices_b[mu] : 1;
      r_env[tid] = (in && !HAS_HALO) ? env[k] : 0;
    }
    // 2. rows k0.. of M (then of hadj), columns m0.., zero past the edges
    for (int i = tid; i < BK * BM; i += THREADS) {
      const int kk = i / BM, c = i % BM;
      const int k = k0 + kk, col = m0 + c;
      int v = 0;
      if (col < m) {
        if (k < n)
          v = M[(size_t)k * m + col];
        else if (HAS_HALO && k < n_all)
          v = hadj[(size_t)(k - n) * m + col];
      }
      m_tile[kk][c] = v;
    }
    __syncthreads();
    // 3. decode S for the tile (t >= T decodes too; its rows are not
    //    written); a halo slot's row is the halo value itself
    for (int i = tid; i < BK * BT; i += THREADS) {
      const int kk = i / BT, r = i % BT;
      const int k = k0 + kk;
      int s = 0;
      if (HAS_HALO && k >= n) {
        const int t = t0 + r;
        if (k < n_all && t < T)
          s = halo[((size_t)b * T + t) * H + (k - n)];
      } else if (r_app[kk]) {
        const unsigned t = (unsigned)(t0 + r);
        const unsigned d =
            (t / (unsigned)r_stride[kk]) % (unsigned)r_choices[kk];
        s = ((int)d == r_rank[kk]);
      }
      s_tile[kk][r] = s;
    }
    __syncthreads();
    // 4. out tile += S tile . M tile, in int32
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      int sv[RT], mv[RM];
#pragma unroll
      for (int r = 0; r < RT; ++r) sv[r] = s_tile[kk][warp + 8 * r];
#pragma unroll
      for (int c = 0; c < RM; ++c) mv[c] = m_tile[kk][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < RM; ++c) acc[r][c] += sv[r] * mv[c];
    }
    if (first_cols && tid < BT) {
      for (int kk = 0; kk < BK; ++kk) e_acc += s_tile[kk][tid] * r_env[kk];
    }
    __syncthreads();
  }

  const int* c_b = configs + (size_t)b * m;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int t = t0 + warp + 8 * r;
    if (t >= T) continue;
    int* row = out + ((size_t)b * T + t) * m;
#pragma unroll
    for (int c = 0; c < RM; ++c) {
      const int col = m0 + lane + 32 * c;
      if (col < m) row[col] = c_b[col] + acc[r][c];
    }
  }
  if (first_cols && tid < BT) {
    const int t = t0 + tid;
    if (t < T) {
      emis[(size_t)b * T + t] = e_acc;
      valid[(size_t)b * T + t] = (float)t < psi[b];
    }
  }
}

template <bool HAS_HALO>
int launch(const void* configs, const void* rank, const void* app,
           const void* stride, const void* choices, const void* psi,
           const void* rule_neuron, const void* M, const void* env,
           const void* hadj, const void* halo, void* out, void* valid,
           void* emis, int B, int T, int n, int m, int H,
           cudaStream_t stream) {
  if (B <= 0 || T <= 0 || m <= 0) return 0;
  const int m_tiles = (m + BM - 1) / BM;
  const int t_tiles = (T + BT - 1) / BT;
  const long long blocks = (long long)B * t_tiles * m_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  snp_step_dense_kernel<HAS_HALO><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const int*)configs, (const int*)rank, (const unsigned char*)app,
      (const int*)stride, (const int*)choices, (const float*)psi,
      (const int*)rule_neuron, (const int*)M, (const int*)env,
      (const signed char*)hadj, (const int*)halo, (int*)out,
      (unsigned char*)valid, (int*)emis, T, n, m, H, m_tiles, t_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point: launches on `stream` (PyTorch's current stream), allocates
// nothing, and returns cudaGetLastError() (0 on success).  All arrays are
// contiguous: configs/stride/choices (B,m), rank/app (B,n), psi (B,),
// rule_neuron/env (n,), M (n,m); out (B,T,m), valid/emis (B,T).
extern "C" int snp_step_dense(const void* configs, const void* rank,
                              const void* app, const void* stride,
                              const void* choices, const void* psi,
                              const void* rule_neuron, const void* M,
                              const void* env, void* out, void* valid,
                              void* emis, int B, int T, int n, int m,
                              void* stream) {
  return launch<false>(configs, rank, app, stride, choices, psi,
                       rule_neuron, M, env, nullptr, nullptr, out, valid,
                       emis, B, T, n, m, 0, (cudaStream_t)stream);
}

// C entry point of the shard body (B6): as above without env, valid and
// emis, plus hadj (H,m) int8 and halo (B,T,H) int32; M is the shard's
// M_local (n,m) and rule_neuron its local rule->neuron map.
extern "C" int snp_step_dense_shard(const void* configs, const void* rank,
                                    const void* app, const void* stride,
                                    const void* choices, const void* psi,
                                    const void* rule_neuron, const void* M,
                                    const void* hadj, const void* halo,
                                    void* out, int B, int T, int n, int m,
                                    int H, void* stream) {
  return launch<true>(configs, rank, app, stride, choices, psi, rule_neuron,
                      M, nullptr, hadj, halo, out, nullptr, nullptr, B, T,
                      n, m, H, (cudaStream_t)stream);
}
