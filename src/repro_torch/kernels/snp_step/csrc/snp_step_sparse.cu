// Sparse SNP transition step for Hopper (sm_90a), bound with ctypes:
// kernels B2, B3 (delay-free), B5 (delayed) and B7 (one neuron shard).
//
// Replaces the bodies of the TPU kernel
// src/repro/kernels/snp_step/sparse_kernel.py::snp_step_sparse_pallas:
// the ELL body _make_kernel(has_coo=False) (B2), the hybrid body
// _make_kernel(has_coo=True) (B3), their delayed bodies (has_delay=True,
// B5) and the shard body (has_halo=True, B7, wrapper
// sparse_ops.py::snp_step_sparse_shard).  One template, the sliced-list
// kernel, runs them all: the COO tail, the delay stage and the halo are
// inputs and flags (the halo excluding the delay, as sparse_kernel.py:76
// asserts), and B2 is the body with none of the three.  For every config
// b and branch id t < T it computes
//
//   d[b,t,mu]     = (t / stride[b,mu]) % choices[b,mu]    (float32, exact)
//   packed[b,t,mu] = tab[b, mu, d]            (produce | consume << 16)
//   in[b,t,j]     = sum over j's in-neighbours s of produce[s]
//                   (+ sum over hub j's COO run of produce[coo_src[e]])
//   out[b,t,j]    = C[b,j] - consume[j] + in[b,t,j]
//   emis[b,t]     = produce[out_neuron]       (0 when out_neuron == m)
//   valid[b,t]    = (float)t < psi[b]
//
// where produce/consume are the fired rule's, and index m (padding, no
// output neuron) reads a zero slot.  The in-neighbours are those of the
// plain version's in_idx (m, Kin), read through the sliced lists
// sell_start/sell_src (below), which hold the same entries; in_idx itself
// reaches no kernel.
//
// The shard body (HAS_HALO): the neuron axis is one shard's mloc local
// neurons, and the lists index the extended space [local (m) | halo (H) |
// zero]: slot m + s holds halo[b,t,s], the fired produce of a remote
// in-neighbour that the halo exchange delivered, and m + H is the zero
// slot, which the wrapper passes as out_neuron (the sharded explore
// judges emissions).  Halo values are fired produce, below 2^16, so they
// fit the stage too.
//
// The delay stage (HAS_DELAY; C is the spikes slice of a [spikes |
// countdown | pending] state row, tab the emit-now table produce*(d==0) |
// consume << 16, and dtab the delayed-action table produce | d << 16,
// 0 where the fired rule has no delay): "produce" above is the emit-now
// value produce[j] + (cd[j] == 1 ? pd[j] : 0), and with (p, dd) the fired
// dtab entry the row is 3m wide:
//
//   cd'  = dd > 0 ? dd : max(cd - 1, 0)
//   out  = [C - consume + (cd' == 0 ? in : 0) | cd' | dd > 0 ? p :
//           (cd == 1 ? 0 : pd)]
//
// The emit-now value still fits the uint16 stage.  A neuron with
// cd == 1 is closed, so none of its rules is applicable, its tab row is
// all 0 and its fired produce is 0: one of the two terms is always 0.
// The fired produce is < 2^16 (compile_system_sparse checks it), and so
// is a pending count, which is only ever set to a fired delayed rule's
// produce or reset to 0.  States that break that invariant (pending >=
// 2^16, which no compiled system reaches) are outside the kernel's
// domain; the plain version sums in int32.
//
// The decode stays exact.  Division is IEEE-rounded `/` (nvcc's default
// -prec-div=true; never --use_fast_math or __fdividef): the floor of
// t / stride is then exact for t < 2^23 (sparse_ref.py::decode_digits
// gives the argument), and t / +inf = 0 is digit 0.  q and c*floor(q/c)
// are integers below 2^23, so every product is exact in float32; if nvcc
// contracts q - c*floor(q/c) into one FMA, the FMA's exact product and
// single rounding give the same integer.  The kernel decodes a neuron
// once for its first row t0 and steps to the next rows in integers
// (struct Digits): a stride is a float32 product of choices (>= 1), exact
// below 2^24, so a stride below T (< 2^23) is an integer s >= 1, and with
// p = t0 - s*floor(t0/s) (exact) the digit of t0 + 1 is the digit of t0,
// advanced by one modulo c when p + 1 reaches s.  A stride >= T (+inf
// included) gives floor(t/stride) = 0 for every t < T, and choices 1
// give digit 0: both skip the divides.
//
// What bounds it.  Per call it writes B*T*m*4 output bytes (3x under
// delays); it reads the (B, m, R) table, C, the strides and choices per
// config (and the (B, T, H) halo), and the in-lists and the COO arrays
// once at best.  The operations the data needs are a digit decode per
// (b, t, neuron), the C - consume per output entry and one add per real
// in-synapse, on the non-tensor datapath: bytes bind every body at the
// smoke's waves (chip_smoke.py::_sparse_bound counts both from each
// call's data).  B=512, T=64: B2 at scaled_pi(682) (m = 2,046) writes
// 268 MB, 0.086 ms at 3.35 TB/s, and at ring_lattice(32768, 8) 4.29 GB,
// 1.28 ms; B3 at power_law(8192) 1.07 GB, 0.32 ms, against 2.1 G
// operations, 0.03 ms at 67 T op/s; B5 at the delayed scaled_pi(682)
// 0.80 GB, 0.25 ms; one B7 shard at the 4-shard scaled_pi(682) (mloc =
// 512) 67 MB, 0.022 ms, and at ring_lattice(32768, 8) (mloc = 8,192)
// 1.07 GB, 0.35 ms.
//
// What the design does about it.  The TPU body keeps (bb, bt, m)
// resident in VMEM because any in-neighbour may be any neuron; here a
// block owns one config and BT rows and stages their fired produce in
// shared memory as uint16.  in_idx read row-major by one thread a neuron
// is not coalesced, and mostly padding: the ELL part of a hybrid encoding
// is 6% real entries at the smoke's power_law(8192) (Kin = 36 slots, mean
// in-degree 2.2).  So the lowering cuts the neurons into slices of 32 and
// stores slice s's entries column by column at sell_start[s] (entry k of
// neuron 32s + l at sell_start[s] + 32k + l, width the slice's longest
// list, padded with m, or with the zero slot m + H for a shard): a warp
// walks its slice with coalesced loads and stops at the slice's width.
// A block owns one config and BT = 8 rows where 8*(m+H+1)*2 bytes fit the
// 227 KB opt-in (m + H <= 14,527; 4, 2 or 1 row past that: 2 at m =
// 32,768) and stages them neuron-major, stage[src*BT + r], so one 16-byte
// shared load returns the 8 rows of a source; the per-config rows
// (stride, choices, configs, tab) are then read by T/8 blocks of a
// config.  Threads: 1024 (32 warps) once every warp has a slice of its
// own (m >= 1,024: B2's and B5's m = 2,046, the ring lattice's m =
// 32,768 and its shards of mloc = 8,192, B3's m = 8,192); 256 below that,
// where 32 warps would leave half idle (B7's shards of mloc = 512 have 16
// slices), four blocks an SM instead of one.  The block shape, the
// stage's loads and stores and the walk over the slices come from
// sliced_lists.cuh, which B4's source shares; measured on the H100 at
// those waves (probes/sell_block_threads.py), each side of the thread
// rule is the faster shape there but for B2 at m = 2,046, where 256
// threads win by 3.5%.  Both shapes are held to 64 registers a thread.
// The kernel waits on dependent global reads (L2 hits), not on
// bandwidth, so every step sends out its reads together:
//   1. each thread decodes neurons j = tid, tid + NT, ... once (Digits;
//      four neurons' reads in flight, the digit-0 table entry read with
//      the stride, as digit 0 is the common case) and stores their BT
//      emit-now values in one vector store; the shard body then stages
//      its rows' halo after the local produce, one halo slot a thread
//      (stage[(m+s)*BT + r] = halo[b, t0+r, s], coalesced reads, one
//      vector store, no divide);
//   2. each warp walks slices warp, warp + NW, ... (lane i loads the
//      bounds of the i-th of the next 32 at once): its lanes' per-config
//      reads go out first, then four list entries at a time, a vector
//      gather each, BT adds; then the lanes re-derive their digits (no
//      divide unless the stride is below T and the choices above 1),
//      re-read the fired consume (and dtab) only where the digit is not
//      0 or changes, and write the BT rows of their 32 neurons, coalesced;
//   3. the COO tail (B3, B5 COO; B2, B5 ELL and B7 have Hn = 0, which
//      skips it and its barrier): after a barrier, each hub's run of
//      coo_src is cut in chunks of 64 entries, numbered over the hubs in
//      order, and chunk i goes to warp i % NW (108 hubs with runs up to
//      1,549 entries at the smoke's system: a hub a warp would leave one
//      warp with most of the work).  A warp sums a chunk's BT rows
//      lane-wise, folds the 8 sums across lanes in 9 shuffles (each
//      halving step hands half the rows to the partner lane), and 8 lanes
//      add the rows onto the hub's outputs with one atomicAdd each (under
//      delays only where the row's cd' is 0, read back from the block's
//      own output).  The hub's neuron comes from hub_neuron, the inverse
//      of hub_slot.
// Integer adds commute, so the atomics leave the result deterministic.
// The kernel reads a list or tail entry outside [0, m + H] as the zero
// slot and clamps slice and run bounds to the lists' lengths, so forged
// lists read nothing out of bounds (one compare an entry, no host read).
//
// A system past snp_step_sparse_max_neurons() (one uint16 row no longer
// fits a block's 227 KB; m + H for a shard) is refused with an error.
// Sums are unsigned 32-bit, so wraparound is defined and equals the
// reference's int32 arithmetic (mod 2^32).

#include <cuda_runtime.h>
#include <stddef.h>

#include "sliced_lists.cuh"

namespace {

using namespace sell;

constexpr int CHUNK = 64;                     // tail entries a warp step

// The digits of one neuron (stride sf, choices c) for rows t0, t0 + 1,
// ... (one step a row), exact as the header argues.  s == 0: every row's
// digit is 0.
struct Digits {
  int d = 0, p = 0, s = 0, c = 1;

  __device__ __forceinline__ Digits(int t0, float sf, int choices, int T) {
    if (!(sf < (float)T) || choices <= 1) return;   // digit 0 for t < T
    c = choices;
    s = (int)sf;
    const float q = floorf((float)t0 / sf);
    const float cf = (float)c;
    p = t0 - (int)q * s;
    d = (int)(q - cf * floorf(q / cf));
  }

  // To the next row; true when the digit changed.
  __device__ __forceinline__ bool step() {
    if (s == 0 || ++p < s) return false;
    p = 0;
    if (++d == c) d = 0;
    return true;
  }
};

// Lanes `off` apart swap halves of their N sums: the lower lane keeps the
// first N/2 rows, the upper the last, each summed over the pair.
template <int N>
__device__ __forceinline__ void fold_half(unsigned* v, int lane, int off) {
  const bool upper = lane & off;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const unsigned send = upper ? v[i] : v[i + N / 2];
    const unsigned keep = upper ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, off);
  }
}

// The warp's sum of each of the BT rows: afterwards v[0] of lane l holds
// row l >> (5 - log2 BT)'s.
template <int BT>
__device__ __forceinline__ int fold_rows(unsigned (&v)[BT], int lane) {
  constexpr int L = BT >= 8 ? 3 : BT >= 4 ? 2 : BT >= 2 ? 1 : 0;
  if constexpr (BT >= 2) fold_half<BT>(v, lane, 16);
  if constexpr (BT >= 4) fold_half<BT / 2>(v, lane, 8);
  if constexpr (BT >= 8) fold_half<BT / 4>(v, lane, 4);
#pragma unroll
  for (int off = 16 >> L; off > 0; off >>= 1)
    v[0] += __shfl_xor_sync(FULL, v[0], off);
  return lane >> (5 - L);
}

template <int BT, int NT, bool HAS_DELAY, bool HAS_HALO>
__global__ void __launch_bounds__(NT, 1024 / NT)
snp_step_sparse_sell_kernel(const int* __restrict__ configs,
                            const float* __restrict__ stride,
                            const int* __restrict__ choices,
                            const float* __restrict__ psi,
                            const int* __restrict__ tab,
                            const int* __restrict__ sell_start,
                            const int* __restrict__ sell_src,
                            const int* __restrict__ out_neuron,
                            const int* __restrict__ coo_src,
                            const int* __restrict__ coo_bounds,
                            const int* __restrict__ hub_neuron,
                            const int* __restrict__ dtab,
                            const int* __restrict__ cd,
                            const int* __restrict__ pd,
                            const int* __restrict__ halo,
                            int* __restrict__ out,
                            unsigned char* __restrict__ valid,
                            int* __restrict__ emis,
                            int T, int m, int R, int E, int Ec, int Hn,
                            int H, int t_tiles,
                            unsigned long long* __restrict__ launches) {
  // one launch counted on the card (kernels/launch_counts.py)
  if (launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(launches, 1ull);
  static_assert(!(HAS_HALO && HAS_DELAY),
                "the shard body has no delay stage");
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned short stage[];  // [m+H+1][BT]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / t_tiles;
  const int t0 = (blockIdx.x % t_tiles) * BT;
  const int nt = min(BT, T - t0);
  const size_t row_b = (size_t)b * m;
  const int W = HAS_DELAY ? 3 * m : m;         // output row width
  const int Z = HAS_HALO ? m + H : m;          // the zero slot
  int* const out_b = out + ((size_t)b * T + t0) * W;

  // 1. the BT emit-now values of each neuron, neuron-major (every load
  //    of a neuron issued at once: tab's digit-0 entry first, the common
  //    digit); a shard's halo rows after them
#pragma unroll 4
  for (int j = tid; j < m; j += NT) {
    const int* tab_j = tab + (row_b + j) * R;
    const float sf = stride[row_b + j];
    const int c = choices[row_b + j];
    const unsigned t_0 = (unsigned)tab_j[0];
    unsigned pending = 0;
    if constexpr (HAS_DELAY)
      if (cd[row_b + j] == 1) pending = (unsigned)pd[row_b + j];
    Digits dg(t0, sf, c, T);
    unsigned p = ((dg.d ? (unsigned)tab_j[dg.d] : t_0) & 0xFFFFu) + pending;
    unsigned v[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      if (r > 0 && dg.step())
        p = ((unsigned)tab_j[dg.d] & 0xFFFFu) + pending;
      v[r] = p;
    }
    put_rows<BT>(stage, j, v);
  }
  if constexpr (HAS_HALO) {
    const int* halo_b = halo + ((size_t)b * T + t0) * H;
    for (int s = tid; s < H; s += NT) {
      unsigned v[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r)
        v[r] = r < nt ? (unsigned)halo_b[(size_t)r * H + s] : 0u;
      put_rows<BT>(stage, m + s, v);
    }
  }
  if (tid == 0) {                              // the zero slot
    unsigned z[BT] = {};
    put_rows<BT>(stage, Z, z);
  }
  __syncthreads();

  // 2. a warp a slice of 32 neurons (sell::SliceBounds): the sliced
  //    lists, then the rows
  const int n_slices = (m + 31) >> 5;
  for (int g = warp; g < n_slices; g += NW * 32) {   // warp-uniform
    const SliceBounds sb(sell_start, g, NW, n_slices, E, lane);
    for (int i = 0; i < sb.n; ++i) {
      int w;
      const int* src = sb.entries(i, sell_src, lane, w);
      const int j = SliceBounds::neuron(i, g, NW, lane);
      // the lane's neuron (lanes past m read neuron m - 1 and store
      // nothing): its reads go out before the gather, which hides them
      const size_t at = row_b + min(j, m - 1);
      const int* tab_j = tab + at * R;
      const float sf = stride[at];
      const int c = choices[at];
      const unsigned cj = (unsigned)configs[at];
      unsigned pk = (unsigned)tab_j[0];
      [[maybe_unused]] int cdj = 0, pdj = 0;
      [[maybe_unused]] unsigned dv = 0;
      if constexpr (HAS_DELAY) {
        cdj = cd[at], pdj = pd[at];
        dv = (unsigned)dtab[at * R];
      }
      unsigned acc[BT];
      gather<BT>(stage, src, w, Z, acc);

      if (j >= m) continue;
      Digits dg(t0, sf, c, T);
      int* o = out_b + j;
      if (dg.d) pk = (unsigned)tab_j[dg.d];
      if constexpr (HAS_DELAY) {
        const int* dtab_j = dtab + at * R;
        const int cd_dec = max((int)((unsigned)cdj - 1u), 0);
        const int pd_kept = cdj == 1 ? 0 : pdj;
        if (dg.d) dv = (unsigned)dtab_j[dg.d];
#pragma unroll
        for (int r = 0; r < BT; ++r, o += W) {
          if (r > 0 && dg.step()) {
            pk = (unsigned)tab_j[dg.d];
            dv = (unsigned)dtab_j[dg.d];
          }
          if (r >= nt) continue;
          const bool fired_del = dv != 0;
          const int cd_next = fired_del ? (int)(dv >> 16) : cd_dec;
          o[0] = (int)(cj - (pk >> 16) + (cd_next == 0 ? acc[r] : 0u));
          o[m] = cd_next;
          o[2 * m] = fired_del ? (int)(dv & 0xFFFF) : pd_kept;
        }
      } else {
#pragma unroll
        for (int r = 0; r < BT; ++r, o += W) {
          if (r > 0 && dg.step()) pk = (unsigned)tab_j[dg.d];
          if (r < nt) o[0] = (int)(cj - (pk >> 16) + acc[r]);
        }
      }
    }
  }

  // 3. the COO tail: chunk i of the hubs' runs (in hub order) to warp
  //    i % NW, after every row is written (the tail adds onto them)
  if (Hn > 0) __syncthreads();                 // block-uniform
  int base = 0;                                // chunks of the hubs before h0
  for (int h0 = 0; h0 < Hn; h0 += 32) {        // warp-uniform
    const int h = h0 + lane;
    int e0 = 0, e1 = 0;
    if (h < Hn) {
      e0 = min(max(coo_bounds[h], 0), Ec);
      e1 = min(max(coo_bounds[h + 1], e0), Ec);
    }
    const int n = (e1 - e0 + CHUNK - 1) / CHUNK;
    int incl = n;                              // inclusive scan of n
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    const int first = base + incl - n;         // number of h's first chunk
    base += __shfl_sync(FULL, incl, 31);
    const int c0 = ((warp - first) % NW + NW) % NW;
    unsigned mine = __ballot_sync(FULL, c0 < n);
    while (mine) {
      const int owner = __ffs(mine) - 1;
      mine &= mine - 1;
      const int r0 = __shfl_sync(FULL, e0, owner);
      const int r1 = __shfl_sync(FULL, e1, owner);
      const int c = __shfl_sync(FULL, c0, owner);
      const int j = hub_neuron[h0 + owner];
      if ((unsigned)j >= (unsigned)m) continue;
      for (int e = r0 + c * CHUNK; e < r1; e += NW * CHUNK) {
        unsigned v[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) v[r] = 0;
#pragma unroll
        for (int u = 0; u < CHUNK / 32; ++u) {
          const int x = e + u * 32 + lane;
          if (x < r1) add_rows<BT>(stage, in_range(coo_src[x], Z), v);
        }
        const int r = fold_rows<BT>(v, lane);
        if ((lane & (32 / BT - 1)) == 0 && r < nt) {
          int* o = out_b + (size_t)r * W + j;
          if (!HAS_DELAY || o[m] == 0)         // cd' == 0: the spikes arrive
            atomicAdd(reinterpret_cast<unsigned*>(o), v[0]);
        }
      }
    }
  }

  // 4. emission and validity of the block's rows
  if (tid < nt) {
    const int t = t0 + tid;
    const int o = out_neuron[0];
    emis[(size_t)b * T + t] =
        (int)stage[((unsigned)o < (unsigned)m ? o : Z) * BT + tid];
    valid[(size_t)b * T + t] = (float)t < psi[b];
  }
}

// One call of the sliced-list kernel (H = 0 but for a shard, Hn = 0 but
// for a hybrid encoding).
struct SellCall {
  const void *configs, *stride, *choices, *psi, *tab, *sell_start,
      *sell_src, *out_neuron, *coo_src, *coo_bounds, *hub_neuron, *dtab, *cd,
      *pd, *halo;
  void *out, *valid, *emis;
  int B, T, m, R, E, Ec, Hn, H;
  void* launches;
  cudaStream_t stream;
};

template <int BT, int NT, bool HAS_DELAY, bool HAS_HALO>
int launch_sell(const SellCall& c) {
  const int t_tiles = (c.T + BT - 1) / BT;
  const size_t smem = (size_t)BT * (c.m + c.H + 1) * 2;
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)c.B * t_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int e = set_smem(
      snp_step_sparse_sell_kernel<BT, NT, HAS_DELAY, HAS_HALO>, smem);
  if (e != 0) return e;
  snp_step_sparse_sell_kernel<BT, NT, HAS_DELAY, HAS_HALO>
      <<<(unsigned)blocks, NT, smem, c.stream>>>(
      (const int*)c.configs, (const float*)c.stride, (const int*)c.choices,
      (const float*)c.psi, (const int*)c.tab, (const int*)c.sell_start,
      (const int*)c.sell_src, (const int*)c.out_neuron,
      (const int*)c.coo_src, (const int*)c.coo_bounds,
      (const int*)c.hub_neuron, (const int*)c.dtab, (const int*)c.cd,
      (const int*)c.pd, (const int*)c.halo, (int*)c.out,
      (unsigned char*)c.valid, (int*)c.emis, c.T, c.m, c.R, c.E, c.Ec, c.Hn,
      c.H, t_tiles, (unsigned long long*)c.launches);
  return (int)cudaGetLastError();
}

template <int NT, bool HAS_DELAY, bool HAS_HALO>
int launch_sell_rows(const SellCall& c, int bt) {
  if (bt == 8) return launch_sell<8, NT, HAS_DELAY, HAS_HALO>(c);
  if (bt == 4) return launch_sell<4, NT, HAS_DELAY, HAS_HALO>(c);
  if (bt == 2) return launch_sell<2, NT, HAS_DELAY, HAS_HALO>(c);
  return launch_sell<1, NT, HAS_DELAY, HAS_HALO>(c);
}

// bt rows and nt threads a block, 0 for the rule's.
template <bool HAS_DELAY, bool HAS_HALO>
int dispatch_sell(const SellCall& c, int bt, int nt) {
  if (bt == 0) bt = rows_per_block(c.m + c.H, c.T, 2);
  if (nt == 0) nt = threads(c.m);
  if (!valid_rows(bt) || !valid_threads(nt))
    return (int)cudaErrorInvalidValue;
  if (nt == 256) return launch_sell_rows<256, HAS_DELAY, HAS_HALO>(c, bt);
  return launch_sell_rows<1024, HAS_DELAY, HAS_HALO>(c, bt);
}

}  // namespace

// The largest m (m + H for a shard) one block's shared-memory stage holds
// (one uint16 row of m + 1 entries in 227 KB).
extern "C" int snp_step_sparse_max_neurons() {
  return sell::SMEM_LIMIT / 2 - 1;
}

// The sliced-list kernel's block shape: rows a block for a system of
// w = m + H neurons (and halo slots) at T branches, threads a block for
// m (local) neurons.
extern "C" int snp_step_sparse_sell_rows(int w, int T) {
  return sell::rows_per_block(w, T, 2);
}
extern "C" int snp_step_sparse_sell_threads(int m) {
  return sell::threads(m);
}

// C entry point: launches one kernel on `stream` (PyTorch's current
// stream), allocates nothing, and returns cudaGetLastError() (0 on
// success).  All arrays are contiguous int32 unless noted: configs and
// choices (B,m), stride (B,m) float32, psi (B,) float32, tab (B,m,R),
// sell_start (ceil(m/32)+1,) and sell_src (E,), the sliced lists,
// out_neuron (1,); with has_coo also coo_src (Ec,), coo_bounds (Hn+1,)
// and hub_neuron (Hn,); with has_delay also dtab (B,m,R), cd and pd
// (B,m); with has_halo (and neither of the other two) halo (B,T,H), the
// lists indexing [local | halo | zero] and out_neuron the zero slot m +
// H.  With none of the three (B2) the tail is empty (Hn = 0).  bt rows
// (1, 2, 4 or 8) and nt threads (256 or 1024) a block, each 0 for the
// rule's (snp_step_sparse_sell_rows, _threads); a shape without an
// instance, or whose stage passes 227 KB, is cudaErrorInvalidValue.
// Outputs: out (B,T,m), or (B,T,3m) with has_delay, valid (B,T) bool,
// emis (B,T).  `launches` (one uint64 counter, or null) gets one added
// on the card when the kernel runs.
extern "C" int snp_step_sparse(const void* configs, const void* stride,
                               const void* choices, const void* psi,
                               const void* tab, const void* sell_start,
                               const void* sell_src, const void* out_neuron,
                               const void* coo_src, const void* coo_bounds,
                               const void* hub_neuron, const void* dtab,
                               const void* cd, const void* pd,
                               const void* halo, void* out, void* valid,
                               void* emis, int B, int T, int m, int R, int E,
                               int Ec, int Hn, int H, int has_coo,
                               int has_delay, int has_halo, int bt, int nt,
                               void* launches, void* stream) {
  if (B <= 0 || T <= 0 || m <= 0) return 0;
  if (has_halo && (has_coo || has_delay)) return (int)cudaErrorInvalidValue;
  const SellCall c{configs, stride, choices, psi, tab, sell_start, sell_src,
                   out_neuron, coo_src, coo_bounds, hub_neuron, dtab, cd, pd,
                   halo, out, valid, emis, B, T, m, R, E,
                   has_coo ? Ec : 0, has_coo ? Hn : 0, has_halo ? H : 0,
                   launches, (cudaStream_t)stream};
  if (has_halo) return dispatch_sell<false, true>(c, bt, nt);
  if (has_delay) return dispatch_sell<true, false>(c, bt, nt);
  return dispatch_sell<false, false>(c, bt, nt);
}
