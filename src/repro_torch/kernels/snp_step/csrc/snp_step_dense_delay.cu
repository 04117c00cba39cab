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
// in-neighbours, the rows of adj_in (m, Kin) derived once from the 0/1
// adjacency at compile time, through their sliced lists (below).  Sums
// are int32 (unsigned, so wraparound is defined), exact wherever the
// reference's f32 sums are (|values| < 2^24).
//
// What bounds it.  Per call it writes B*T*3m*4 output bytes and reads far
// less: the configs' three slices, rank and app per config, the per-rule
// arrays and the lists once at best.  The operations the data needs are a
// digit decode per (b, t, neuron), a compare per applicable rule, the
// combine per output entry and one add per synapse.  At the delayed
// scaled_pi(682) explore wave (B=512, T=64, n=3410, m=2046) that is
// 805 MB of output, 0.24 ms at 3.35 TB/s, against a few G operations:
// bytes bind (chip_smoke.py::_dense_delay_bound counts both from each
// call's data).  The TPU's S.W alone would be 2*B*T*n*4m = 1.83 T
// operations, and emit.adjacency another 0.27 T.
//
// What the design does about it.  incoming needs the whole emit row
// before any column can be combined, so a block owns one config b and BT
// branch ids and works in two phases over the neuron axis, as the sparse
// source's sliced-list kernel does for the sparse encoding (B5):
//   1. each thread decodes neurons j = tid, tid + NT, ... once, for row
//      t0, and steps to the next rows in integers (struct Digits: the
//      strides are int32, clamped to 2^30, so the stepping is exact),
//      walks the neuron's rule segment once (one app/rank read serves all
//      rows) and stores its BT emit-now values in the stage in one or two
//      vector stores.  The stage is neuron-major, stage[src*BT + r], so a
//      source's 8 rows come back in two 16-byte shared loads, and int32:
//      the dense encoding does not bound produce below 2^16 and a pending
//      count may reach 2^16 - 1 beside a fired produce.  Slot m is a zero
//      that list padding and a missing output neuron read.
//   2. each warp walks slices warp, warp + NW, ... of 32 neurons (lane i
//      loads the bounds of the i-th of the next 32 at once) over the
//      sliced lists of adj_in, sell_start/sell_src (core/matrix.py::
//      sliced_in_lists: entry k of neuron 32s + l at sell_start[s] + 32k
//      + l, the slice as wide as its longest list, padded with m): its
//      lanes' per-config reads go out first, then four list entries at a
//      time, coalesced, a vector gather each, BT adds.  Each lane then
//      finds its neuron's fired consume, delay and delayed produce by
//      walking its rule segment for row t0 and again only where the
//      stepped digit changes, and writes 3*BT outputs, the warp's 32
//      neurons side by side.
// BT = 8 rows a block wherever 8*(m+1)*4 bytes fit the 227 KB opt-in
// (m <= 7,263), else 4, 2 or 1; 1024 threads (32 warps) once every warp
// has a 32-neuron slice of its own (m >= 1,024), else 256.  The block
// shape, the stage's loads and stores and the walk over the slices come
// from sliced_lists.cuh, which the sparse source shares; at the delayed
// scaled_pi(682) wave the thread rule was measured for B4 too
// (probes/sell_block_threads.py).  Both shapes are held to 64 registers
// a thread.  A system past
// snp_step_dense_delay_max_neurons() (one int32 row no longer fits a
// block's 227 KB) is refused with an error.  The kernel reads a list
// entry outside [0, m] as the zero slot and clamps slice starts to the
// lists' length, so forged lists read nothing out of bounds (one compare
// an entry, no host read).
//
// Phase 2 could instead read which rule fired, staged by phase 1 (a byte
// per neuron and row).  Both were built and timed on an H100 at the
// delayed scaled_pi(682) wave: the walk took 0.5196 / 0.5211 ms, the
// staged variant 0.5660 / 0.5680 ms (segments average 1.7 rules), and
// the staged variant spilled 24 bytes at 8 rows and 1024 threads, so
// only the walk is kept.
//
// Determinism: no atomics; every output is written by exactly one thread,
// and integer sums do not depend on their order.

#include <cuda_runtime.h>
#include <stddef.h>

#include "sliced_lists.cuh"

namespace {

using namespace sell;

// The digits of one neuron (stride s, choices c) for rows t0, t0 + 1,
// ... (one step a row), in integers.  A stride >= T gives digit 0 for
// every t < T, as do choices 1 (and a stride below 1, outside the
// wrapper's domain): s == 0 marks that case.
struct Digits {
  int d = 0, p = 0, s = 0, c = 1;

  __device__ __forceinline__ Digits(int t0, int stride, int choices, int T) {
    if (stride >= T || stride < 1 || choices <= 1) return;
    s = stride;
    c = choices;
    const int q = t0 / s;
    p = t0 - q * s;
    d = q % c;
  }

  // To the next row; true when the digit changed.
  __device__ __forceinline__ bool step() {
    if (s == 0 || ++p < s) return false;
    p = 0;
    if (++d == c) d = 0;
    return true;
  }
};

// Shared bytes of a block of BT rows over m neurons.
size_t stage_bytes(int bt, int m) { return (size_t)bt * (m + 1) * 4; }

template <int BT, int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
snp_step_dense_delay_sell_kernel(const int* __restrict__ spikes,
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
                                 const int* __restrict__ sell_start,
                                 const int* __restrict__ sell_src,
                                 const int* __restrict__ out_neuron,
                                 int* __restrict__ out,
                                 unsigned char* __restrict__ valid,
                                 int* __restrict__ emis,
                                 int T, int n, int m, int E, int t_tiles,
                                 unsigned long long* __restrict__ launches) {
  // one launch counted on the card (kernels/launch_counts.py)
  if (launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(launches, 1ull);
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned stage[];   // [m + 1][BT]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / t_tiles;
  const int t0 = (blockIdx.x % t_tiles) * BT;
  const int nt = min(BT, T - t0);
  const size_t row_b = (size_t)b * m;
  const int* const rank_b = rank + (size_t)b * n;
  const unsigned char* const app_b = app + (size_t)b * n;
  const int W = 3 * m;                          // output row width
  int* const out_b = out + ((size_t)b * T + t0) * W;

  // 1. the BT emit-now values of each neuron, neuron-major: one decode,
  //    one walk of the rule segment
  for (int j = tid; j < m; j += NT) {
    const int sj = stride[row_b + j], cj = choices[row_b + j];
    const int i0 = rule_bounds[j], i1 = rule_bounds[j + 1];
    const unsigned pending =
        cd[row_b + j] == 1 ? (unsigned)pd[row_b + j] : 0u;
    Digits dg(t0, sj, cj, T);
    int d[BT];
    unsigned e[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      if (r > 0) dg.step();
      d[r] = dg.d;
      e[r] = pending;
    }
    for (int i = i0; i < i1; ++i) {
      const bool a = app_b[i];
      const int rk = rank_b[i];
      const unsigned now = delay[i] == 0 ? (unsigned)produce[i] : 0u;
      if (!a) continue;
#pragma unroll
      for (int r = 0; r < BT; ++r)
        if (d[r] == rk) e[r] += now;
    }
    put_rows<BT>(stage, j, e);
  }
  if (tid == 0) {                              // the zero slot
    unsigned z[BT] = {};
    put_rows<BT>(stage, m, z);
  }
  __syncthreads();

  // 2. a warp a slice of 32 neurons (sell::SliceBounds): the sliced
  //    lists, then the fired actions and the combine
  const int n_slices = (m + 31) >> 5;
  for (int g = warp; g < n_slices; g += NW * 32) {   // warp-uniform
    const SliceBounds sb(sell_start, g, NW, n_slices, E, lane);
    for (int i = 0; i < sb.n; ++i) {
      int w;
      const int* src = sb.entries(i, sell_src, lane, w);
      const int j = SliceBounds::neuron(i, g, NW, lane);
      // the lane's neuron (lanes past m read neuron m - 1 and store
      // nothing): its reads go out before the gather, which hides them
      const int jc = min(j, m - 1);
      const size_t at = row_b + jc;
      const int sj = stride[at], cj = choices[at];
      const int i0 = rule_bounds[jc], i1 = rule_bounds[jc + 1];
      const unsigned spk = (unsigned)spikes[at];
      const int cdj = cd[at], pdj = pd[at];
      unsigned acc[BT];
      gather<BT>(stage, src, w, m, acc);

      if (j >= m) continue;
      // the fired consume, delay and delayed produce of the digit dgt
      unsigned cons = 0, dd = 0, pend = 0;
      auto walk = [&](int dgt) {
        cons = dd = pend = 0;
        for (int q = i0; q < i1; ++q) {
          const bool ok = app_b[q];
          if (!ok || rank_b[q] != dgt) continue;
          const unsigned di = (unsigned)delay[q];
          cons += (unsigned)consume[q];
          dd += di;
          pend += di != 0 ? (unsigned)produce[q] : 0u;
        }
      };
      Digits dg(t0, sj, cj, T);
      const int cd_dec = max((int)((unsigned)cdj - 1u), 0);
      const int pd_kept = cdj == 1 ? 0 : pdj;
      int* o = out_b + j;
#pragma unroll
      for (int r = 0; r < BT; ++r, o += W) {
        if (r >= nt) break;
        if (r == 0 || dg.step()) walk(dg.d);  // where the digit changes
        const bool fired_del = (int)dd > 0;
        const int cd_next = fired_del ? (int)dd : cd_dec;
        o[0] = (int)(spk - cons + (cd_next == 0 ? acc[r] : 0u));
        o[m] = cd_next;
        o[2 * m] = fired_del ? (int)pend : pd_kept;
      }
    }
  }

  // 3. emission and validity of the block's rows
  if (tid < nt) {
    const int t = t0 + tid;
    const int o = out_neuron[0];
    emis[(size_t)b * T + t] =
        (int)stage[((unsigned)o < (unsigned)m ? o : m) * BT + tid];
    valid[(size_t)b * T + t] = (float)t < psi[b];
  }
}

struct Call {
  const void *spikes, *cd, *pd, *rank, *app, *stride, *choices, *psi,
      *rule_bounds, *consume, *produce, *delay, *sell_start, *sell_src,
      *out_neuron;
  void *out, *valid, *emis;
  int B, T, n, m, E;
  void* launches;
  cudaStream_t stream;
};

template <int BT, int NT>
int launch(const Call& c) {
  const int t_tiles = (c.T + BT - 1) / BT;
  const size_t smem = stage_bytes(BT, c.m);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)c.B * t_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = snp_step_dense_delay_sell_kernel<BT, NT>;
  const int e = set_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<(unsigned)blocks, NT, smem, c.stream>>>(
      (const int*)c.spikes, (const int*)c.cd, (const int*)c.pd,
      (const int*)c.rank, (const unsigned char*)c.app, (const int*)c.stride,
      (const int*)c.choices, (const float*)c.psi, (const int*)c.rule_bounds,
      (const int*)c.consume, (const int*)c.produce, (const int*)c.delay,
      (const int*)c.sell_start, (const int*)c.sell_src,
      (const int*)c.out_neuron, (int*)c.out, (unsigned char*)c.valid,
      (int*)c.emis, c.T, c.n, c.m, c.E, t_tiles,
      (unsigned long long*)c.launches);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_rows(const Call& c, int bt) {
  if (bt == 8) return launch<8, NT>(c);
  if (bt == 4) return launch<4, NT>(c);
  if (bt == 2) return launch<2, NT>(c);
  return launch<1, NT>(c);
}

}  // namespace

// The largest m one block's shared-memory stage holds (one int32 row of
// m + 1 entries in 227 KB).
extern "C" int snp_step_dense_delay_max_neurons() {
  return sell::SMEM_LIMIT / 4 - 1;
}

// The block shape: rows a block and threads a block for m neurons at T
// branches.
extern "C" int snp_step_dense_delay_rows(int m, int T) {
  return sell::rows_per_block(m, T, 4);
}
extern "C" int snp_step_dense_delay_threads(int m) {
  return sell::threads(m);
}

// C entry point: launches one kernel on `stream` (PyTorch's current
// stream), allocates nothing, and returns cudaGetLastError() (0 on
// success).  All arrays are contiguous int32 unless noted: spikes, cd, pd,
// stride and choices (B,m), rank (B,n), app (B,n) bool, psi (B,) float32,
// rule_bounds (m+1,), consume, produce and delay (n,), sell_start
// (ceil(m/32)+1,) and sell_src (E,), the sliced lists of adj_in,
// out_neuron (1,).  bt rows (1, 2, 4 or 8) and nt threads (256 or 1024) a
// block, each 0 for the rule's (snp_step_dense_delay_rows, _threads); a
// shape without an instance, or whose stage passes 227 KB, is
// cudaErrorInvalidValue.  Outputs: out (B,T,3m), valid (B,T) bool, emis
// (B,T).  `launches` (one uint64 counter, or null) gets one added on
// the card when the kernel runs.
extern "C" int snp_step_dense_delay(
    const void* spikes, const void* cd, const void* pd, const void* rank,
    const void* app, const void* stride, const void* choices,
    const void* psi, const void* rule_bounds, const void* consume,
    const void* produce, const void* delay, const void* sell_start,
    const void* sell_src, const void* out_neuron, void* out, void* valid,
    void* emis, int B, int T, int n, int m, int E, int bt, int nt,
    void* launches, void* stream) {
  if (B <= 0 || T <= 0 || m <= 0) return 0;
  const Call c{spikes, cd, pd, rank, app, stride, choices, psi, rule_bounds,
               consume, produce, delay, sell_start, sell_src, out_neuron,
               out, valid, emis, B, T, n, m, E, launches,
               (cudaStream_t)stream};
  if (bt == 0) bt = rows_per_block(m, T, 4);
  if (nt == 0) nt = threads(m);
  if (!valid_rows(bt) || !valid_threads(nt))
    return (int)cudaErrorInvalidValue;
  if (nt == 256) return launch_rows<256>(c, bt);
  return launch_rows<1024>(c, bt);
}
