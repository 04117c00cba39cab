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
// produce the halo exchange delivered, over the halo in-adjacency:
//
//   out[b,t,j] += sum of halo[b,t,s] over the slots s with hadj[s,j] != 0
//
// and writes neither emissions nor validity (the sharded explore judges
// those).  M (and env, B1's column m) and hadj are read as column lists
// built once per encoding (core/matrix.py::column_lists): column j's
// nonzeros are rules col_rule[col_start[j] .. col_start[j+1]), ascending,
// with values col_val; hadj's are halo slots hcol_slot[...] under
// hcol_start.  Sums are unsigned int32 (wraparound is defined, so their
// order does not matter), equal to the plain version's f32 sums wherever
// those are exact (|values| < 2^24).  The lists are the kernel's only
// view of the matrices; an entry that names a rule outside 0..n-1 or a
// slot outside 0..H-1, and a start past the list's length (nnz, hnnz),
// are skipped, so no list, however made, reads out of bounds.
//
// What bounds it.  Per call it must write B*T*m*4 output bytes and read
// the inputs once: the configs, rank and app per config, and M and hadj
// as their nonzeros (the lists), plus for B6 the halo, B*T*H*4 bytes.
// The operations the data needs are few: a digit decode per rule and
// branch, and per fired rule the nonzeros of its row (at most one rule
// fires per neuron).  At the full-width explore wave (B=512, T=64,
// n=3410, m=2046; M holds 7,502 nonzeros of 6.98 M entries) that is 268
// MB of output against well under a G operations, so bytes bind (about
// 0.08 ms at 3.35 TB/s); the dense contraction would be 2*B*T*n*m = 457
// G.  At a shard of scaled_pi(682) over four shards bytes bind too: 67
// MB out, plus 179 MB of halo under the degree partition (1,364 slots).
//
// What the design does about it.  A block owns one config b and a tile of
// ROWS branch ids t0 .. t0+ROWS-1 (the rule: ROWS = 16 for B1; for B6 the
// largest power of two up to 8 whose halo slab fits the stage; both picked
// on the card: fewer rows, fewer registers and more blocks in flight,
// against a decode per tile; the C entries also take ROWS explicitly, 8,
// 16 or 32 for B1 and 1, 2, 4 or 8 for B6, which the planner's autotuner
// times), so its output is one contiguous slab of ROWS*m int32.
// Nothing dense is walked:
//   0. (B6) halo[b, t0 .. t0+ROWS-1, :] is contiguous: thread 0 stages it
//      in shared memory with one 1-D TMA bulk copy (cp.async.bulk) that
//      completes on an mbarrier while phase 1 runs; a slab that is not
//      16-byte aligned is staged by plain coalesced loads instead, and
//      one too large for the stage is read in place;
//   1. each rule's fired rows become one 32-bit mask in shared memory:
//      the digit of rows t0.. is decoded once per rule (one divide, then
//      increments), so a rule's app/rank/stride reads serve all ROWS rows.
//      The stage holds RULE_CHUNK rules (32 KB); a longer rule axis is
//      walked in chunks, each column finding its chunk's entries by a
//      binary search of its ascending list and carrying its sums through
//      the output, so no size is refused;
//   2. each thread takes an output column j (B1: m+1 columns, the last
//      one env's, which yields emis): ROWS accumulators start at C[b,j]
//      (plus, for B6, j's halo slots read from the stage), the column's
//      list adds each entry's value on the rows its rule's mask has set
//      (a rule that fired on no row is skipped), and the ROWS results are
//      stored, neighbouring threads on neighbouring columns: each warp
//      store is 128 contiguous bytes of one output row.  (Staging the
//      slab in shared memory to store it 16 bytes a thread, and
//      streaming stores, were both slower on the card.)
// At the wave the whole walk is about 1.5 operations per output byte.
// Tensor cores do not serve it: an int8 wgmma would redo all 457 G dense
// operations and need |M| <= 127, which the lowering does not promise.
//
// Determinism: no atomics; every output is written by exactly one thread.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;                  // 8 warps
constexpr int MAX_ROWS = 32;                  // one bit each in a rule's mask
constexpr int B1_ROWS = 16;                   // rows per block of B1
constexpr int B6_MAX_ROWS = 8;                // ... at most, of B6
static_assert(B1_ROWS <= MAX_ROWS && B6_MAX_ROWS <= MAX_ROWS,
              "a rule's mask holds MAX_ROWS rows");
constexpr int RULE_CHUNK = 8192;              // rules per mask stage (32 KB)
constexpr int HALO_STAGE_TARGET = 96 * 1024;  // B6's stage aimed for
constexpr int SMEM_LIMIT = 232448;            // opt-in max per block (227 KB)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until phase 0 of the barrier has completed.  A wait past about 10 s
// (2^34 clocks) traps: a fault, never a hang.
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// One contiguous run of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The rows r < ROWS of the tile at t0 on which a rule fires: its neuron's
// digit (t / s) % c equals its rank rk.  One divide, then increments.
template <int ROWS>
__device__ __forceinline__ unsigned fire_mask(unsigned t0, unsigned s,
                                              unsigned c, unsigned rk) {
  const unsigned q = t0 / s;
  unsigned rem = t0 - q * s;
  unsigned d = q % c;
  unsigned mask = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    mask |= (unsigned)(d == rk) << r;
    if (++rem == s) {
      rem = 0;
      if (++d == c) d = 0;
    }
  }
  return mask;
}

// First position in a[lo, hi) (ascending) holding a value >= key.
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int lo,
                                           int hi, int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <bool HAS_HALO, int ROWS>
__global__ void __launch_bounds__(THREADS)
snp_step_dense_kernel(const int* __restrict__ configs,
                      const int* __restrict__ rank,
                      const unsigned char* __restrict__ app,
                      const int* __restrict__ stride,
                      const int* __restrict__ choices,
                      const float* __restrict__ psi,
                      const int* __restrict__ rule_neuron,
                      const int* __restrict__ col_start,
                      const int* __restrict__ col_rule,
                      const int* __restrict__ col_val,
                      const int* __restrict__ hcol_start,
                      const int* __restrict__ hcol_slot,
                      const int* __restrict__ halo,
                      int* __restrict__ out,
                      unsigned char* __restrict__ valid,
                      int* __restrict__ emis,
                      int T, int n, int m, int H, int nnz, int hnnz,
                      int t_tiles, int chunk, int halo_words,
                      unsigned long long* __restrict__ launches) {
  // one launch counted on the card (kernels/launch_counts.py)
  if (launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(launches, 1ull);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar;
  int* halo_s = reinterpret_cast<int*>(smem);            // [ROWS][H]
  unsigned* mask_s = reinterpret_cast<unsigned*>(
      smem + ((size_t)halo_words * 4 + 15) / 16 * 16);   // [chunk]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / t_tiles;
  const int t0 = (blockIdx.x % t_tiles) * ROWS;
  const int nt = min(ROWS, T - t0);
  const size_t row0 = (size_t)b * T + t0;
  const int cols = HAS_HALO ? m : m + 1;    // B1: column m is env's
  const int* rank_b = rank + (size_t)b * n;
  const unsigned char* app_b = app + (size_t)b * n;
  const int* stride_b = stride + (size_t)b * m;
  const int* choices_b = choices + (size_t)b * m;

  // 0. (B6) the halo slab of the block's rows
  const int* hsrc = nullptr;       // row r of the slab at hsrc + r * H
  bool tma = false;
  if (HAS_HALO) {
    const int* g = halo + row0 * H;
    hsrc = g;
    if (halo_words > 0) {
      const unsigned bytes = (unsigned)nt * (unsigned)H * 4u;
      tma = ((reinterpret_cast<uintptr_t>(g) & 15) == 0) &&
            (bytes & 15u) == 0;
      if (tma) {
        const uint32_t b_addr = smem_u32(&bar);
        if (tid == 0) mbar_init(b_addr, 1);
        __syncthreads();
        if (tid == 0) {
          mbar_expect_tx(b_addr, bytes);
          bulk_load(smem_u32(halo_s), g, bytes, b_addr);
        }
      } else {
        for (int k = tid; k < nt * H; k += THREADS) halo_s[k] = g[k];
      }
      hsrc = halo_s;
    }
  }

  for (int k0 = 0;; k0 += chunk) {
    const int k1 = min(n, k0 + chunk);
    // 1. the fired rows of each rule of the chunk, as a mask
    for (int i = k0 + tid; i < k1; i += THREADS) {
      unsigned mk = 0;
      if (app_b[i]) {
        const int mu = rule_neuron[i];
        mk = fire_mask<ROWS>((unsigned)t0, (unsigned)stride_b[mu],
                             (unsigned)choices_b[mu], (unsigned)rank_b[i]);
      }
      mask_s[i - k0] = mk;
    }
    if (HAS_HALO && tma && k0 == 0) mbar_wait0(smem_u32(&bar));
    __syncthreads();

    // 2. one output column per thread
    const bool first = k0 == 0;
    const bool whole = first && k1 == n;      // one chunk holds every rule
    for (int j = tid; j < cols; j += THREADS) {
      const bool env_col = !HAS_HALO && j == m;
      unsigned acc[ROWS];
      if (first) {
        const unsigned c0 = env_col ? 0u : (unsigned)configs[(size_t)b * m + j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = c0;
        if (HAS_HALO) {
          const int h1 = min(hcol_start[j + 1], hnnz);
          for (int e = max(hcol_start[j], 0); e < h1; ++e) {
            const int s = __ldg(hcol_slot + e);
            if ((unsigned)s >= (unsigned)H) continue;   // not a slot
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              if (r < nt) acc[r] += (unsigned)hsrc[r * H + s];
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[r] = r >= nt ? 0u
                   : env_col ? (unsigned)emis[row0 + r]
                             : (unsigned)out[(row0 + r) * m + j];
      }
      int lo = max(col_start[j], 0), hi = min(col_start[j + 1], nnz);
      if (!whole) {
        lo = lower_bound(col_rule, lo, hi, k0);
        hi = lower_bound(col_rule, lo, hi, k1);
      }
      for (int e = lo; e < hi; ++e) {
        // the entry's rule, as an index into this chunk's masks
        const unsigned ri = (unsigned)__ldg(col_rule + e) - (unsigned)k0;
        if (ri >= (unsigned)(k1 - k0)) continue;   // not in this chunk
        const unsigned mk = mask_s[ri];
        if (mk == 0) continue;
        const unsigned v = (unsigned)__ldg(col_val + e);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] += ((mk >> r) & 1u) ? v : 0u;
      }
      if (env_col) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (r < nt) emis[row0 + r] = (int)acc[r];
      } else {
        int* o = out + row0 * m + j;
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (r < nt) o[(size_t)r * m] = (int)acc[r];
      }
    }
    if (k1 >= n) break;
    __syncthreads();                         // before the next chunk's masks
  }
  if (!HAS_HALO && tid < nt)
    valid[row0 + tid] = (float)(t0 + tid) < psi[b];
}

struct Args {
  const void *configs, *rank, *app, *stride, *choices, *psi, *rule_neuron,
      *col_start, *col_rule, *col_val, *hcol_start, *hcol_slot, *halo;
  void *out, *valid, *emis;
  int B, T, n, m, H, nnz, hnnz;
  void* launches;
};

template <bool HAS_HALO, int ROWS>
int launch_rows(const Args& a, int chunk, bool staged, cudaStream_t stream) {
  const int t_tiles = (a.T + ROWS - 1) / ROWS;
  const long long blocks = (long long)a.B * t_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int halo_words = staged ? ROWS * a.H : 0;
  const size_t smem = ((size_t)halo_words * 4 + 15) / 16 * 16 +
                      (size_t)chunk * 4;
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = snp_step_dense_kernel<HAS_HALO, ROWS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const int*)a.configs, (const int*)a.rank,
      (const unsigned char*)a.app, (const int*)a.stride,
      (const int*)a.choices, (const float*)a.psi, (const int*)a.rule_neuron,
      (const int*)a.col_start, (const int*)a.col_rule, (const int*)a.col_val,
      (const int*)a.hcol_start, (const int*)a.hcol_slot, (const int*)a.halo,
      (int*)a.out, (unsigned char*)a.valid, (int*)a.emis, a.T, a.n, a.m, a.H,
      a.nnz, a.hnnz, t_tiles, chunk, halo_words,
      (unsigned long long*)a.launches);
  return (int)cudaGetLastError();
}

// B6's rule: the largest row tile whose halo slab fits the stage beside
// the masks; a slab past even one row is read in place, at 8 rows.
bool halo_fits(int rows, int H, int chunk) {
  return (size_t)rows * H * 4 + (size_t)chunk * 4 <= HALO_STAGE_TARGET;
}

int shard_rule_rows(int H, int chunk) {
  for (int rows = B6_MAX_ROWS; rows >= 1; rows >>= 1)
    if (halo_fits(rows, H, chunk)) return rows;
  return B6_MAX_ROWS;
}

int rule_chunk(int n) {
  return n < RULE_CHUNK ? (n > 0 ? n : 1) : RULE_CHUNK;
}

}  // namespace

// The rule's rows a block: B1's, and B6's for a shard of n rules and H
// halo slots.
extern "C" int snp_step_dense_rows() { return B1_ROWS; }
extern "C" int snp_step_dense_shard_rows(int n, int H) {
  return shard_rule_rows(H, rule_chunk(n));
}

// C entry point: launches on `stream` (PyTorch's current stream), allocates
// nothing, and returns cudaGetLastError() (0 on success).  All arrays are
// contiguous int32 unless noted: configs/stride/choices (B,m), rank (B,n),
// app (B,n) bool, psi (B,) float32, rule_neuron (n,); the column lists of
// [M | env] (n, m+1): col_start (m+2,), col_rule and col_val (nnz,).
// bt rows a block (8, 16 or 32; 0 for the rule's 16) and nt threads (256,
// or 0); another shape is cudaErrorInvalidValue.  Outputs: out (B,T,m),
// valid (B,T) bool, emis (B,T).  `launches` (one uint64 counter, or
// null) gets one added on the card when the kernel runs.
extern "C" int snp_step_dense(const void* configs, const void* rank,
                              const void* app, const void* stride,
                              const void* choices, const void* psi,
                              const void* rule_neuron, const void* col_start,
                              const void* col_rule, const void* col_val,
                              void* out, void* valid, void* emis, int B,
                              int T, int n, int m, int nnz, int bt, int nt,
                              void* launches, void* stream) {
  if (B <= 0 || T <= 0 || m <= 0) return 0;
  if (nt != 0 && nt != THREADS) return (int)cudaErrorInvalidValue;
  const Args a{configs, rank,      app,      stride,  choices, psi,
               rule_neuron, col_start, col_rule, col_val, nullptr, nullptr,
               nullptr, out, valid, emis, B, T, n, m, 0, nnz, 0,
               launches};
  const int chunk = rule_chunk(n);
  cudaStream_t s = (cudaStream_t)stream;
  switch (bt ? bt : B1_ROWS) {
    case 8: return launch_rows<false, 8>(a, chunk, false, s);
    case 16: return launch_rows<false, 16>(a, chunk, false, s);
    case 32: return launch_rows<false, 32>(a, chunk, false, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// C entry point of the shard body (B6): as above without valid and emis;
// col_* are the lists of M_local (n, m) alone (col_start (m+1,)),
// hcol_start (m+1,) and hcol_slot (hnnz,) those of the halo in-adjacency
// hadj (H, m), and halo (B,T,H) int32 the exchanged remote produce;
// rule_neuron is the shard's local rule->neuron map.  bt rows a block (1,
// 2, 4 or 8; 0 for the rule's, snp_step_dense_shard_rows) and nt threads
// (256, or 0); the halo slab is staged where it fits beside the masks and
// read in place where it does not.
extern "C" int snp_step_dense_shard(const void* configs, const void* rank,
                                    const void* app, const void* stride,
                                    const void* choices, const void* psi,
                                    const void* rule_neuron,
                                    const void* col_start,
                                    const void* col_rule,
                                    const void* col_val,
                                    const void* hcol_start,
                                    const void* hcol_slot, const void* halo,
                                    void* out, int B, int T, int n, int m,
                                    int H, int nnz, int hnnz, int bt, int nt,
                                    void* launches, void* stream) {
  if (B <= 0 || T <= 0 || m <= 0) return 0;
  if (nt != 0 && nt != THREADS) return (int)cudaErrorInvalidValue;
  const Args a{configs,    rank,      app,  stride,  choices, psi,
               rule_neuron, col_start, col_rule, col_val, hcol_start,
               hcol_slot, halo, out, nullptr, nullptr, B, T, n, m, H, nnz,
               hnnz, launches};
  const int chunk = rule_chunk(n);
  const int rows = bt ? bt : shard_rule_rows(H, chunk);
  const bool staged = H > 0 && halo_fits(rows, H, chunk);
  cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case 8: return launch_rows<true, 8>(a, chunk, staged, s);
    case 4: return launch_rows<true, 4>(a, chunk, staged, s);
    case 2: return launch_rows<true, 2>(a, chunk, staged, s);
    case 1: return launch_rows<true, 1>(a, chunk, staged, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
