// Dense delayed SNP transition step for Hopper (sm_90a), bound with ctypes:
// kernel B4.
//
// Replaces the delayed body of the TPU kernel
// src/repro/kernels/snp_step/kernel.py::snp_step_pallas
// (_make_kernel(has_halo=False, has_delay=True): the accumulation of S.W
// and the combine after the last rule tile).  A state row is [spikes |
// countdown | pending], 3m wide.  For every config b and branch id t < T,
// with mu(i) the neuron of rule i (rules are neuron-sorted, so neuron mu
// owns rules rule_bounds[mu] .. rule_bounds[mu+1] - 1):
//
//   S[b,t,i]  = app[b,i] && (t / stride[b,mu(i)]) % choices[b,mu(i)]
//                          == rank[b,i]
//   for each neuron j, summed over its rules i (at most one fires):
//     cons[j] = S consume,  now[j] = S produce (d=0),
//     dd[j]   = S delay,    pend[j] = S produce (d>0)
//   emit[j]   = now[j] + (cd[j] == 1 ? pd[j] : 0)          (emit-now)
//   in[j]     = sum of emit[i] over the in-neighbours i of j
//   cd'[j]    = dd[j] > 0 ? dd[j] : max(cd[j] - 1, 0)
//   out[b,t]  = [C - cons + (cd' == 0 ? in : 0) | cd' |
//                dd > 0 ? pend : (cd == 1 ? 0 : pd)]
//   emis[b,t] = emit[out_neuron]            (0 when out_neuron == m)
//   valid[b,t] = (float)t < psi[b]
//
// This is the TPU kernel's S.W with W = [consume | produce(d=0) | d |
// produce(d>0)] (core/semantics.py::delayed_weight_matrix) and its
// emit.adjacency, computed without either product: the sums over a
// neuron's rules are its segment's few rules, and in[j] reads j's
// in-neighbour list adj_in (m, Kin), derived once from the 0/1 adjacency
// at compile time.  Sums are int32 (unsigned, so wraparound is defined),
// exact wherever the reference's f32 sums are (|values| < 2^24).
//
// What bounds it.  Per call it writes B*T*3m*4 output bytes and reads far
// less: the configs' three slices, rank and app per config, the per-rule
// arrays and adj_in once at best.  The operations the data needs are a
// digit decode per (b, t, neuron), a compare per applicable rule, the
// combine per output entry and one add per synapse.  At the delayed
// scaled_pi(682) explore wave (B=512, T=64, n=3410, m=2046) that is
// 805 MB of output, 0.24 ms at 3.35 TB/s, against a few G operations:
// bytes bind (chip_smoke.py::_dense_delay_bound counts both from each
// call's data).  The TPU's S.W alone would be 2*B*T*n*4m = 1.83 T
// operations, and emit.adjacency another 0.27 T.
//
// What the design does about it.  incoming needs the whole emit row
// before any column can be combined, so a block owns one config b and
// BT branch ids (BT a power of two up to 8, chosen so the stage stays
// within 64 KB: 8 rows at m = 2046) and works in two phases over the
// neuron axis.  Phase 1 gives each thread a neuron, decodes its digit
// for the BT rows, walks its rule segment once (one app/rank read serves
// all rows) and stages emit in shared memory as int32: BT*(m+1)*4 bytes,
// the extra slot a zero that adj_in's padding (index m) and a missing
// output neuron read.  Phase 2 gives each thread a neuron j, walks j's
// segment again for cons, dd and pend, gathers j's in-neighbours from
// shared memory for all BT rows (one adj_in read serves BT branches) and
// writes 3*BT output entries, neighbouring threads on neighbouring
// columns.  A row of adj_in stops at its first padding entry, so a
// heavy-tailed graph (Kin = the top in-degree) costs its synapses, not
// m*Kin.  No block reads the (m, m) adjacency.  A system past
// snp_step_dense_delay_max_neurons() (one row no longer fits a block's
// 227 KB) is refused with an error.  A persistent grid and coalesced
// adj_in reads are later work.
//
// Determinism: no atomics; every output is written by exactly one thread,
// and integer sums do not depend on their order.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;                  // 8 warps
constexpr int BT_MAX = 8;                     // branch rows per block
constexpr int STAGE_TARGET = 64 * 1024;       // shared bytes aimed for
constexpr int SMEM_LIMIT = 232448;            // opt-in max per block (227 KB)

__global__ void __launch_bounds__(THREADS)
snp_step_dense_delay_kernel(const int* __restrict__ spikes,
                            const int* __restrict__ cd,
                            const int* __restrict__ pd,
                            const int* __restrict__ rank,
                            const unsigned char* __restrict__ app,
                            const int* __restrict__ stride,
                            const int* __restrict__ choices,
                            const float* __restrict__ psi,
                            const int* __restrict__ rule_bounds,
                            const int* __restrict__ consume,
                            const int* __restrict__ produce,
                            const int* __restrict__ delay,
                            const int* __restrict__ adj_in,
                            const int* __restrict__ out_neuron,
                            int* __restrict__ out,
                            unsigned char* __restrict__ valid,
                            int* __restrict__ emis,
                            int T, int n, int m, int Kin, int bt,
                            int t_tiles) {
  extern __shared__ int emit_s[];              // [bt][m + 1]
  const int tid = threadIdx.x;
  const int b = blockIdx.x / t_tiles;
  const int t0 = (blockIdx.x % t_tiles) * bt;
  const int nt = min(bt, T - t0);
  const int ms = m + 1;
  const size_t row_b = (size_t)b * m;
  const int* rank_b = rank + (size_t)b * n;
  const unsigned char* app_b = app + (size_t)b * n;

  // 1. emit-now of each (row, neuron) into shared memory
  for (int mu = tid; mu < m; mu += THREADS) {
    const unsigned s = (unsigned)stride[row_b + mu];
    const unsigned c = (unsigned)choices[row_b + mu];
    int dg[BT_MAX];
    unsigned e[BT_MAX];
#pragma unroll
    for (int r = 0; r < BT_MAX; ++r) {
      dg[r] = (int)(((unsigned)(t0 + r) / s) % c);
      e[r] = 0;
    }
    const int i1 = rule_bounds[mu + 1];
    for (int i = rule_bounds[mu]; i < i1; ++i) {
      if (!app_b[i]) continue;
      const int rk = rank_b[i];
      const unsigned now = delay[i] == 0 ? (unsigned)produce[i] : 0u;
#pragma unroll
      for (int r = 0; r < BT_MAX; ++r)
        if (dg[r] == rk) e[r] += now;
    }
    const unsigned pending =
        cd[row_b + mu] == 1 ? (unsigned)pd[row_b + mu] : 0u;
#pragma unroll
    for (int r = 0; r < BT_MAX; ++r)
      if (r < nt) emit_s[r * ms + mu] = (int)(e[r] + pending);
  }
  if (tid < nt) emit_s[tid * ms + m] = 0;      // the zero slot
  __syncthreads();

  // 2. one neuron per thread: the fired rule's actions, the incoming
  //    spikes over the in-neighbours, the combine
  for (int j = tid; j < m; j += THREADS) {
    const unsigned s = (unsigned)stride[row_b + j];
    const unsigned c = (unsigned)choices[row_b + j];
    int dg[BT_MAX];
    unsigned cons[BT_MAX], dd[BT_MAX], pend[BT_MAX], in[BT_MAX];
#pragma unroll
    for (int r = 0; r < BT_MAX; ++r) {
      dg[r] = (int)(((unsigned)(t0 + r) / s) % c);
      cons[r] = dd[r] = pend[r] = in[r] = 0;
    }
    const int i1 = rule_bounds[j + 1];
    for (int i = rule_bounds[j]; i < i1; ++i) {
      if (!app_b[i]) continue;
      const int rk = rank_b[i];
      const unsigned ci = (unsigned)consume[i], di = (unsigned)delay[i];
      const unsigned pi = di != 0 ? (unsigned)produce[i] : 0u;
#pragma unroll
      for (int r = 0; r < BT_MAX; ++r)
        if (dg[r] == rk) cons[r] += ci, dd[r] += di, pend[r] += pi;
    }
    const int* row = adj_in + (size_t)j * Kin;
    for (int k = 0; k < Kin; ++k) {
      const int src = row[k];
      if (src >= m) break;                     // the row's padding starts
#pragma unroll
      for (int r = 0; r < BT_MAX; ++r)
        if (r < nt) in[r] += (unsigned)emit_s[r * ms + src];
    }
    const unsigned sj = (unsigned)spikes[row_b + j];
    const int cdj = cd[row_b + j], pdj = pd[row_b + j];
    const int cd_dec = max((int)((unsigned)cdj - 1u), 0);
    int* out_j = out + ((size_t)b * T + t0) * 3 * m + j;
#pragma unroll
    for (int r = 0; r < BT_MAX; ++r) {
      if (r >= nt) continue;
      const bool fired_del = (int)dd[r] > 0;
      const int cd_next = fired_del ? (int)dd[r] : cd_dec;
      int* o = out_j + (size_t)r * 3 * m;
      o[0] = (int)(sj - cons[r] + (cd_next == 0 ? in[r] : 0u));
      o[m] = cd_next;
      o[2 * m] = fired_del ? (int)pend[r] : (cdj == 1 ? 0 : pdj);
    }
  }

  // 3. emission and validity of the block's rows (emit_s is still live)
  if (tid < nt) {
    const int t = t0 + tid;
    const int o = out_neuron[0];
    emis[(size_t)b * T + t] = emit_s[tid * ms + (o >= 0 && o < m ? o : m)];
    valid[(size_t)b * T + t] = (float)t < psi[b];
  }
}

// Rows per block: the largest power of two <= BT_MAX (and <= T) whose
// stage fits STAGE_TARGET; 1 when even one row is larger.
int rows_per_block(int m, int T) {
  int bt = BT_MAX;
  while (bt > 1 && (bt > T || (size_t)bt * (m + 1) * 4 > STAGE_TARGET))
    bt >>= 1;
  return bt;
}

}  // namespace

// The largest m one block's shared-memory stage holds (one int32 row of
// m + 1 entries in 227 KB).
extern "C" int snp_step_dense_delay_max_neurons() {
  return SMEM_LIMIT / 4 - 1;
}

// C entry point: launches one kernel on `stream` (PyTorch's current
// stream), allocates nothing, and returns cudaGetLastError() (0 on
// success).  All arrays are contiguous int32 unless noted: spikes, cd, pd,
// stride and choices (B,m), rank (B,n), app (B,n) bool, psi (B,) float32,
// rule_bounds (m+1,), consume, produce and delay (n,), adj_in (m,Kin),
// out_neuron (1,).  Outputs: out (B,T,3m), valid (B,T) bool, emis (B,T).
extern "C" int snp_step_dense_delay(
    const void* spikes, const void* cd, const void* pd, const void* rank,
    const void* app, const void* stride, const void* choices,
    const void* psi, const void* rule_bounds, const void* consume,
    const void* produce, const void* delay, const void* adj_in,
    const void* out_neuron, void* out, void* valid, void* emis, int B,
    int T, int n, int m, int Kin, void* stream) {
  if (B <= 0 || T <= 0 || m <= 0) return 0;
  const int bt = rows_per_block(m, T);
  const int t_tiles = (T + bt - 1) / bt;
  const size_t smem = (size_t)bt * (m + 1) * 4;
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * t_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        snp_step_dense_delay_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  snp_step_dense_delay_kernel<<<(unsigned)blocks, THREADS, smem,
                                (cudaStream_t)stream>>>(
      (const int*)spikes, (const int*)cd, (const int*)pd, (const int*)rank,
      (const unsigned char*)app, (const int*)stride, (const int*)choices,
      (const float*)psi, (const int*)rule_bounds, (const int*)consume,
      (const int*)produce, (const int*)delay, (const int*)adj_in,
      (const int*)out_neuron, (int*)out, (unsigned char*)valid, (int*)emis,
      T, n, m, Kin, bt, t_tiles);
  return (int)cudaGetLastError();
}
