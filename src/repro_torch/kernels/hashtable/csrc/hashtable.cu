// Open-addressing hash-table probes for Hopper (sm_90a), bound with
// ctypes: kernels H1 (lookup) and H2 (claim-insert).
//
// Replaces no Pallas kernel: these are the port's counterparts of the
// reference's probe lax.while_loops (src/repro/core/hashtable.py::lookup,
// :153, and ::_claim_loop, :215), which the BFS level runs on the device.
// The plain versions are kernels/hashtable/ref.py (PyTorch loops over the
// same rounds); both kernels equal them bit for bit.
//
// The table: S slots (a power of two), two uint32 hash lanes held in int64
// (SENTINEL in both when empty) and an int32 payload.  Keys arrive
// canonical (ops.py: invalid lanes are the empty marker, a real key equal
// to it is remapped).  Key k's chain starts at
//   base(k) = fmix32(hi ^ (lo * 0x9E3779B1)) & (S - 1)
// and walks linearly for at most D probes.
//
// H1, lookup: one thread per candidate walks its own chain until it meets
// its key (found, payload), an empty slot or D probes.  Read-only, so no
// thread sees another's work and there are no races.
//
// H2, claim-insert, shared by insert_unique (on the visited table) and
// first_occurrence (on a scratch table).  Its rule, the reference's: of an
// equal-key group in one batch only the lowest-indexed candidate wins, and
// the table's layout is a function of the batch alone.  It runs the plain
// version's rounds (at most 2*D + 1) in one cooperative launch:
//   phase A  every pending candidate reads its slot as the round found it:
//            its key -> duplicate; empty -> a claim, atomicMin of its index
//            on the slot's claim word; a foreign key -> one probe further
//            (D probes -> overflow);
//   (grid sync)
//   phase B  a claimer whose index is the slot's claim word writes its key
//            and payload there and resets the word; the others hold their
//            position and re-read the slot next round; every block adds
//            its still-pending candidates to the round's count;
//   (grid sync)  the round's count is 0 -> every block returns.
// So a claim is decided by the minimum over the claimers, never by which
// compare-and-swap came first, and no table entry is written in phase A.
// Reads of the table and the claim words bypass L1 (__ldcg): they see the
// other blocks' phase-B writes after the grid sync.
//
// What bounds them: bytes.  H1 reads each candidate's key (16 B) and the
// slots its chain touches (16 B each, random), and writes 5 B a candidate;
// H2 reads the keys and payloads (20 B a candidate) and touches the same
// slots per round, plus the claim words (4 B a slot, initialised once a
// call).  At the full-width wave (32,768 candidates, a visited table of
// 524,288 slots) that is well under 3 MB a call, a microsecond of the
// card's 3.35 TB/s; the grid syncs (two a round) and the dependent random
// reads set the time, so the design keeps every thread's candidates'
// state in device memory and does nothing between syncs but its probes.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr long long kSentinel = 0xFFFFFFFFLL;
constexpr int kThreads = 256;

enum : unsigned char { kIdle = 0, kPending = 1, kClaiming = 2, kWon = 3,
                       kDup = 4, kOverflow = 5 };

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ long long base_slot(long long hi, long long lo,
                                               long long mask) {
  uint32_t h = (uint32_t)hi, l = (uint32_t)lo;
  return (long long)(fmix32(h ^ (l * 0x9E3779B1u))) & mask;
}

__global__ void lookup_kernel(const long long* __restrict__ s_hi,
                              const long long* __restrict__ s_lo,
                              const int* __restrict__ s_pay,
                              const long long* __restrict__ hi,
                              const long long* __restrict__ lo,
                              const bool* __restrict__ valid,
                              bool* __restrict__ found,
                              int* __restrict__ payload, int K, long long S,
                              int D,
                              unsigned long long* __restrict__ launches) {
  // one launch counted on the card (kernels/launch_counts.py)
  if (launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(launches, 1ull);
  const long long mask = S - 1;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < K;
       i += gridDim.x * blockDim.x) {
    bool f = false;
    int pay = -1;
    if (valid[i]) {
      const long long h = hi[i], l = lo[i];
      const long long b = base_slot(h, l, mask);
      for (int p = 0; p < D; ++p) {
        const long long s = (b + p) & mask;
        const long long ch = s_hi[s], cl = s_lo[s];
        if (ch == h && cl == l) {
          f = true;
          pay = s_pay[s];
          break;
        }
        if (ch == kSentinel && cl == kSentinel) break;
      }
    }
    found[i] = f;
    payload[i] = pay;
  }
}

struct ClaimArgs {
  long long* s_hi;
  long long* s_lo;
  int* s_pay;
  const long long* hi;
  const long long* lo;
  const bool* pending;
  const int* payload;
  int* claim;            // (S,) scratch claim words
  int* probe;            // (K,) scratch probe counts
  unsigned char* state;  // (K,) scratch candidate states
  int* count;            // (3,) scratch per-round pending counts
  bool* won;
  bool* dup;
  bool* overflow;        // () any candidate overflowed
  int K;
  long long S;
  int D;
  unsigned long long* launches;  // one uint64 counter, or null
};

__global__ void __launch_bounds__(kThreads)
claim_kernel(ClaimArgs a) {
  // one launch counted on the card (kernels/launch_counts.py)
  if (a.launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(a.launches, 1ull);
  cg::grid_group grid = cg::this_grid();
  const long long mask = a.S - 1;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  __shared__ int block_pending;

  for (long long s = tid; s < a.S; s += nthreads) a.claim[s] = INT_MAX;
  for (long long i = tid; i < a.K; i += nthreads) {
    a.state[i] = a.pending[i] ? kPending : kIdle;
    a.probe[i] = 0;
    a.won[i] = false;
    a.dup[i] = false;
  }
  if (tid == 0) {
    *a.overflow = false;
    a.count[0] = a.count[1] = a.count[2] = 0;
  }
  grid.sync();

  const int rounds = 2 * a.D + 1;
  for (int r = 0; r < rounds; ++r) {
    // phase A: read the slot as this round found it; claim, match or move
    if (tid == 0) a.count[(r + 1) % 3] = 0;
    for (long long i = tid; i < a.K; i += nthreads) {
      if (a.state[i] != kPending) continue;
      const long long h = a.hi[i], l = a.lo[i];
      int p = a.probe[i];
      const long long s = (base_slot(h, l, mask) + p) & mask;
      const long long ch = __ldcg(a.s_hi + s), cl = __ldcg(a.s_lo + s);
      if (ch == h && cl == l) {
        a.state[i] = kDup;
        a.dup[i] = true;
      } else if (ch == kSentinel && cl == kSentinel) {
        atomicMin(a.claim + s, (int)i);
        a.state[i] = kClaiming;
      } else {
        a.probe[i] = ++p;
        if (p >= a.D) {
          a.state[i] = kOverflow;
          *a.overflow = true;
        }
      }
    }
    grid.sync();
    // phase B: the lowest claimer of each slot writes it; the rest hold
    if (threadIdx.x == 0) block_pending = 0;
    __syncthreads();
    int mine = 0;
    for (long long i = tid; i < a.K; i += nthreads) {
      const unsigned char st = a.state[i];
      if (st == kClaiming) {
        const long long h = a.hi[i], l = a.lo[i];
        const long long s = (base_slot(h, l, mask) + a.probe[i]) & mask;
        if (__ldcg(a.claim + s) == (int)i) {
          a.s_hi[s] = h;
          a.s_lo[s] = l;
          a.s_pay[s] = a.payload[i];
          a.claim[s] = INT_MAX;
          a.state[i] = kWon;
          a.won[i] = true;
        } else {
          a.state[i] = kPending;
          ++mine;
        }
      } else if (st == kPending) {
        ++mine;
      }
    }
    if (mine) atomicAdd(&block_pending, mine);
    __syncthreads();
    if (threadIdx.x == 0 && block_pending) atomicAdd(a.count + r % 3,
                                                     block_pending);
    grid.sync();
    if (__ldcg(a.count + r % 3) == 0) break;
  }
}

int coop_grid(long long work) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, claim_kernel, kThreads,
                                                0);
  long long want = (work + kThreads - 1) / kThreads;
  long long most = (long long)sms * (per > 0 ? per : 1);
  if (want < 1) want = 1;
  return (int)(want < most ? want : most);
}

}  // namespace

// C entry points: launch on `stream` (PyTorch's current stream), allocate
// nothing, return cudaGetLastError() (0 on success).  Keys hi/lo (K,)
// int64 holding uint32 lanes, canonical; the table s_hi/s_lo (S,) int64,
// s_pay (S,) int32, S a power of two; D probes at most.  `launches` (one
// uint64 counter, or null) gets one added on the card when the kernel
// runs.

// H1: found (K,) bool and payload (K,) int32 (-1 when absent).
extern "C" int hashtable_lookup(const void* s_hi, const void* s_lo,
                                const void* s_pay, const void* hi,
                                const void* lo, const void* valid,
                                void* found, void* payload, int K,
                                long long S, int D, void* launches,
                                void* stream) {
  if (K <= 0) return 0;
  if (S <= 0 || (S & (S - 1)) != 0 || D < 0) return (int)cudaErrorInvalidValue;
  int blocks = (K + kThreads - 1) / kThreads;
  lookup_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)s_hi, (const long long*)s_lo, (const int*)s_pay,
      (const long long*)hi, (const long long*)lo, (const bool*)valid,
      (bool*)found, (int*)payload, K, S, D,
      (unsigned long long*)launches);
  return (int)cudaGetLastError();
}

// H2: claims the pending candidates into the table in place (payload (K,)
// int32 goes with each winner); won, dup (K,) bool and overflow () bool
// out.  Scratch: claim (S,) int32, probe (K,) int32, state (K,) uint8,
// count (3,) int32.
extern "C" int hashtable_claim(void* s_hi, void* s_lo, void* s_pay,
                               const void* hi, const void* lo,
                               const void* pending, const void* payload,
                               void* claim, void* probe, void* state,
                               void* count, void* won, void* dup,
                               void* overflow, int K, long long S, int D,
                               void* launches, void* stream) {
  if (S <= 0 || (S & (S - 1)) != 0 || D < 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  ClaimArgs a{(long long*)s_hi, (long long*)s_lo, (int*)s_pay,
              (const long long*)hi, (const long long*)lo,
              (const bool*)pending, (const int*)payload, (int*)claim,
              (int*)probe, (unsigned char*)state, (int*)count, (bool*)won,
              (bool*)dup, (bool*)overflow, K, S, D,
              (unsigned long long*)launches};
  void* args[] = {&a};
  const long long work = (long long)K > S ? (long long)K : S;
  return (int)cudaLaunchCooperativeKernel((void*)claim_kernel,
                                          coop_grid(work), kThreads, args, 0,
                                          (cudaStream_t)stream);
}

// H2's cooperative grid (blocks of kThreads) for `work` candidates or
// slots, for the wrapper's records.
extern "C" int hashtable_claim_blocks(long long work) {
  return coop_grid(work);
}
