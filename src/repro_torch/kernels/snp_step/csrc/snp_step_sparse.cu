// Sparse SNP transition step for Hopper (sm_90a), bound with ctypes:
// kernels B2, B3 (delay-free), B5 (delayed) and B7 (one neuron shard).
//
// Replaces the bodies of the TPU kernel
// src/repro/kernels/snp_step/sparse_kernel.py::snp_step_sparse_pallas:
// the ELL body _make_kernel(has_coo=False), the hybrid body
// _make_kernel(has_coo=True) (B2, B3), their delayed bodies
// (has_delay=True, B5) and the shard body (has_halo=True, B7, wrapper
// sparse_ops.py::snp_step_sparse_shard), here one template with the COO
// stage, the delay stage and the halo as flags (the halo excludes the
// other two, as sparse_kernel.py:76 asserts).  For every config b and
// branch id t < T it computes
//
//   d[b,t,mu]     = (t / stride[b,mu]) % choices[b,mu]    (float32, exact)
//   packed[b,t,mu] = tab[b, mu, d]            (produce | consume << 16)
//   in[b,t,j]     = sum_k produce[in_idx[j,k]]
//                   (+ sum over hub_slot[j]'s run of produce[coo_src[e]])
//   out[b,t,j]    = C[b,j] - consume[j] + in[b,t,j]
//   emis[b,t]     = produce[out_neuron]       (0 when out_neuron == m)
//   valid[b,t]    = (float)t < psi[b]
//
// where produce/consume are the fired rule's, and index m (ELL padding,
// no output neuron) reads a zero slot.
//
// The shard body (HAS_HALO): the neuron axis is one shard's mloc local
// neurons, and in_idx indexes the extended space [local (m) | halo (H) |
// zero]: slot m + s holds halo[b,t,s], the fired produce of a remote
// in-neighbour that the halo exchange delivered, and m + H is the zero
// slot, which the wrapper passes as out_neuron (the sharded explore
// judges emissions).  Halo values are fired produce, below 2^16, so they fit the
// stage too.
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
// single rounding give the same integer.
//
// What bounds it.  Per call it writes B*T*m*4 output bytes; it reads the
// (B, m, R) table, C, the strides and choices per config, and in_idx
// (m*Kin*4) and the COO arrays once at best.  The operations the data
// needs are a digit decode per (b, t, neuron), the C - consume per output
// entry and one add per real in-synapse, on the non-tensor datapath.  At
// the hybrid explore wave (B=512, T=64, m=8192, 32,768 synapses) that is
// 1.07 GB of output, 0.32 ms at 3.35 TB/s, against about 2.1 G
// operations, 0.03 ms at 67 T op/s: bytes bind (chip_smoke.py::
// _sparse_bound counts both from each call's data).  The kernel itself
// also adds the ELL padding: Kin = 36 slots a neuron where the mean
// in-degree is 4.
//
// What the design does about it.  The TPU body keeps (bb, bt, m) resident
// in VMEM because any in_idx[j,k] may point at any neuron.  Here a block
// owns one config b and BT branch ids and stages the fired produce of its
// BT rows in shared memory as uint16 (compile_system_sparse guarantees
// produce < 2^16): BT*(m+H+1)*2 bytes (H = 0 but for a shard), BT a power
// of two up to 8 chosen so the stage stays within 64 KB where m allows
// (one row at m = 32768 is 64 KB).  The shard body copies its rows' halo
// into the stage after the local produce; phase 2 then gathers local and
// remote in-neighbours alike.  Phase 1 decodes and stages; phase 2 gives each thread a neuron
// j, recomputes its fired consume (a second table read, instead of a
// second shared array), gathers its in-synapses from shared memory for
// all BT rows (one in_idx read serves BT branches), and writes BT output
// entries.  The COO stage (hybrid plans): each warp finds the hubs among
// its 32 neurons (ballot) and sums each hub's contiguous run of coo_src
// cooperatively, 32 entries a step, reduced by shuffles; the TPU's
// zero-fronted cumsum differenced at coo_bounds computes the same int32
// sums (mod 2^32).  Sums are unsigned 32-bit, so wraparound is defined and
// equals the reference's int32 arithmetic.  A system past
// snp_step_sparse_max_neurons() (one row no longer fits a block's 227 KB)
// (m + H for a shard) is refused with an error.
// Coalescing in_idx (it is read row-major, Kin ints per thread), a
// persistent grid and warp-per-neuron gathers for hubs are later work.
//
// The delay stage adds, per block, the cd and pd reads of phase 1 and a
// dtab read per (row, neuron) in phase 2, and writes 3m columns a row:
// bytes bind it too (3.2 GB of output at the delayed hybrid wave).
//
// Determinism: no atomics; every output is written by exactly one thread,
// and integer sums do not depend on their order.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;                  // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int BT_MAX = 8;                     // branch rows per block
constexpr int STAGE_TARGET = 64 * 1024;       // shared bytes aimed for
constexpr int SMEM_LIMIT = 232448;            // opt-in max per block (227 KB)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int digit(int t, float s, float c) {
  const float q = floorf((float)t / s);
  return (int)(q - c * floorf(q / c));
}

template <bool HAS_COO, bool HAS_DELAY, bool HAS_HALO>
__global__ void __launch_bounds__(THREADS)
snp_step_sparse_kernel(const int* __restrict__ configs,
                       const float* __restrict__ stride,
                       const int* __restrict__ choices,
                       const float* __restrict__ psi,
                       const int* __restrict__ tab,
                       const int* __restrict__ in_idx,
                       const int* __restrict__ out_neuron,
                       const int* __restrict__ coo_src,
                       const int* __restrict__ coo_bounds,
                       const int* __restrict__ hub_slot,
                       const int* __restrict__ dtab,
                       const int* __restrict__ cd,
                       const int* __restrict__ pd,
                       const int* __restrict__ halo,
                       int* __restrict__ out,
                       unsigned char* __restrict__ valid,
                       int* __restrict__ emis,
                       int T, int m, int R, int Kin, int Hn, int H, int bt,
                       int t_tiles) {
  static_assert(!(HAS_HALO && (HAS_COO || HAS_DELAY)),
                "the shard body has neither a COO nor a delay stage");
  extern __shared__ unsigned short prod_s[];   // [bt][m + H + 1]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / t_tiles;
  const int t0 = (blockIdx.x % t_tiles) * bt;
  const int nt = min(bt, T - t0);
  const int ms = m + H + 1;                    // stage row; m + H is zero
  const size_t row_b = (size_t)b * m;
  const int W = HAS_DELAY ? 3 * m : m;         // output row width

  // 1. fired (emit-now) produce of each (row, neuron) into shared memory
  for (int j = tid; j < m; j += THREADS) {
    const float s = stride[row_b + j];
    const float c = (float)choices[row_b + j];
    const int* tab_j = tab + (row_b + j) * R;
    unsigned pending = 0;
    if constexpr (HAS_DELAY)
      if (cd[row_b + j] == 1) pending = (unsigned)pd[row_b + j];
#pragma unroll
    for (int r = 0; r < BT_MAX; ++r)
      if (r < nt)
        prod_s[r * ms + j] = (unsigned short)(
            (tab_j[digit(t0 + r, s, c)] & 0xFFFF) + pending);
  }
  if constexpr (HAS_HALO) {                    // remote produce after it
    const int* halo_b = halo + ((size_t)b * T + t0) * H;
    for (int i = tid; i < nt * H; i += THREADS)
      prod_s[(i / H) * ms + m + i % H] = (unsigned short)halo_b[i];
  }
  if (tid < nt) prod_s[tid * ms + m + H] = 0;  // the zero slot
  __syncthreads();

  // 2. one neuron per thread: C - consume + in-synapses (+ hub tail);
  //    under delays acc holds the incoming sum alone until the combine
  for (int j0 = warp * 32; j0 < m; j0 += NWARPS * 32) {   // warp-uniform
    const int j = j0 + lane;
    const bool active = j < m;
    unsigned acc[BT_MAX];
    int dg[BT_MAX];
#pragma unroll
    for (int r = 0; r < BT_MAX; ++r) acc[r] = 0, dg[r] = 0;
    const int* tab_j = tab + (row_b + j) * R;
    if (active) {
      const float s = stride[row_b + j];
      const float c = (float)choices[row_b + j];
      const unsigned cj = (unsigned)configs[row_b + j];
#pragma unroll
      for (int r = 0; r < BT_MAX; ++r) {
        if (r >= nt) continue;
        dg[r] = digit(t0 + r, s, c);
        if (!HAS_DELAY) acc[r] = cj - ((unsigned)tab_j[dg[r]] >> 16);
      }
      const int* row = in_idx + (size_t)j * Kin;
      for (int k = 0; k < Kin; ++k) {
        const int src = row[k];
#pragma unroll
        for (int r = 0; r < BT_MAX; ++r)
          if (r < nt) acc[r] += prod_s[r * ms + src];
      }
    }
    if constexpr (HAS_COO) {
      const int h = active ? hub_slot[j] : Hn;
      unsigned hubs = __ballot_sync(FULL, h < Hn);
      while (hubs) {                           // warp-uniform loop
        const int owner = __ffs(hubs) - 1;
        hubs &= hubs - 1;
        const int hh = __shfl_sync(FULL, h, owner);
        const int e1 = coo_bounds[hh + 1];
        unsigned sum[BT_MAX];
#pragma unroll
        for (int r = 0; r < BT_MAX; ++r) sum[r] = 0;
        for (int e = coo_bounds[hh] + lane; e < e1; e += 32) {
          const int src = coo_src[e];
#pragma unroll
          for (int r = 0; r < BT_MAX; ++r)
            if (r < nt) sum[r] += prod_s[r * ms + src];
        }
#pragma unroll
        for (int r = 0; r < BT_MAX; ++r) {
          unsigned v = sum[r];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(FULL, v, off);
          if (lane == owner) acc[r] += v;
        }
      }
    }
    if (active) {
      int* out_j = out + ((size_t)b * T + t0) * W + j;
      if constexpr (HAS_DELAY) {
        const unsigned cj = (unsigned)configs[row_b + j];
        const int cdj = cd[row_b + j], pdj = pd[row_b + j];
        const int* dtab_j = dtab + (row_b + j) * R;
        const int cd_dec = max((int)((unsigned)cdj - 1u), 0);
#pragma unroll
        for (int r = 0; r < BT_MAX; ++r) {
          if (r >= nt) continue;
          const unsigned dv = (unsigned)dtab_j[dg[r]];
          const bool fired_del = dv != 0;
          const int cd_next = fired_del ? (int)(dv >> 16) : cd_dec;
          const unsigned cons = (unsigned)tab_j[dg[r]] >> 16;
          int* o = out_j + (size_t)r * W;
          o[0] = (int)(cj - cons + (cd_next == 0 ? acc[r] : 0u));
          o[m] = cd_next;
          o[2 * m] = fired_del ? (int)(dv & 0xFFFF)
                               : (cdj == 1 ? 0 : pdj);
        }
      } else {
#pragma unroll
        for (int r = 0; r < BT_MAX; ++r)
          if (r < nt) out_j[(size_t)r * W] = (int)acc[r];
      }
    }
  }

  // 3. emission and validity of the block's rows (prod_s is still live)
  if (tid < nt) {
    const int t = t0 + tid;
    const int o = out_neuron[0];
    emis[(size_t)b * T + t] = (int)prod_s[tid * ms + (o < m ? o : m + H)];
    valid[(size_t)b * T + t] = (float)t < psi[b];
  }
}

// Rows per block: the largest power of two <= BT_MAX (and <= T) whose
// stage of w entries a row fits STAGE_TARGET; 1 when even one row is
// larger.
int rows_per_block(int w, int T) {
  int bt = BT_MAX;
  while (bt > 1 && (bt > T || (size_t)bt * w * 2 > STAGE_TARGET))
    bt >>= 1;
  return bt;
}

template <bool HAS_COO, bool HAS_DELAY, bool HAS_HALO>
int launch(const void* configs, const void* stride, const void* choices,
           const void* psi, const void* tab, const void* in_idx,
           const void* out_neuron, const void* coo_src,
           const void* coo_bounds, const void* hub_slot, const void* dtab,
           const void* cd, const void* pd, const void* halo, void* out,
           void* valid, void* emis, int B, int T, int m, int R, int Kin,
           int Hn, int H, cudaStream_t stream) {
  const int bt = rows_per_block(m + H + 1, T);
  const int t_tiles = (T + bt - 1) / bt;
  const size_t smem = (size_t)bt * (m + H + 1) * 2;
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)B * t_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        snp_step_sparse_kernel<HAS_COO, HAS_DELAY, HAS_HALO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  snp_step_sparse_kernel<HAS_COO, HAS_DELAY, HAS_HALO>
      <<<(unsigned)blocks, THREADS, smem, stream>>>(
          (const int*)configs, (const float*)stride, (const int*)choices,
          (const float*)psi, (const int*)tab, (const int*)in_idx,
          (const int*)out_neuron, (const int*)coo_src,
          (const int*)coo_bounds, (const int*)hub_slot, (const int*)dtab,
          (const int*)cd, (const int*)pd, (const int*)halo, (int*)out,
          (unsigned char*)valid, (int*)emis, T, m, R, Kin, Hn, H, bt,
          t_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest m (m + H for a shard) one block's shared-memory stage holds
// (one uint16 row of m + 1 entries in 227 KB).
extern "C" int snp_step_sparse_max_neurons() { return SMEM_LIMIT / 2 - 1; }

// C entry point: launches one kernel on `stream` (PyTorch's current
// stream), allocates nothing, and returns cudaGetLastError() (0 on
// success).  All arrays are contiguous int32 unless noted: configs and
// choices (B,m), stride (B,m) float32, psi (B,) float32, tab (B,m,R),
// in_idx (m,Kin), out_neuron (1,); with has_coo != 0 also coo_src (Ec,),
// coo_bounds (Hn+1,) and hub_slot (m,); with has_delay != 0 also dtab
// (B,m,R), cd and pd (B,m); with has_halo != 0 (and neither of the other
// two) halo (B,T,H), in_idx indexing [local | halo | zero] and out_neuron
// the zero slot m + H.  Outputs: out (B,T,m), or (B,T,3m) with has_delay,
// valid (B,T) bool, emis (B,T).
extern "C" int snp_step_sparse(const void* configs, const void* stride,
                               const void* choices, const void* psi,
                               const void* tab, const void* in_idx,
                               const void* out_neuron, const void* coo_src,
                               const void* coo_bounds, const void* hub_slot,
                               const void* dtab, const void* cd,
                               const void* pd, const void* halo, void* out,
                               void* valid, void* emis, int B, int T, int m,
                               int R, int Kin, int Hn, int H, int has_coo,
                               int has_delay, int has_halo, void* stream) {
  if (B <= 0 || T <= 0 || m <= 0) return 0;
  if (has_halo && (has_coo || has_delay)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SNP_LAUNCH(COO, DELAY, HALO)                                       \
  return launch<COO, DELAY, HALO>(configs, stride, choices, psi, tab,      \
                                  in_idx, out_neuron, coo_src, coo_bounds, \
                                  hub_slot, dtab, cd, pd, halo, out,       \
                                  valid, emis, B, T, m, R, Kin, Hn,        \
                                  HALO ? H : 0, s)
  if (has_halo) SNP_LAUNCH(false, false, true);
  if (has_coo) {
    if (has_delay) SNP_LAUNCH(true, true, false);
    SNP_LAUNCH(true, false, false);
  }
  if (has_delay) SNP_LAUNCH(false, true, false);
  SNP_LAUNCH(false, false, false);
#undef SNP_LAUNCH
}
