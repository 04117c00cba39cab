// Open-addressing hash-table probes for Hopper (sm_90a), bound with
// ctypes: kernel H1 (hash and lookup) and kernel H2 (claim-insert).
//
// Replaces no Pallas kernel: these are the port's counterparts of the
// reference's probe lax.while_loops (src/repro/core/hashtable.py::lookup,
// :153, and ::_claim_loop, :215) and of its config_hash
// (src/repro/core/hashing.py:46), which the BFS level runs on the device.
// The plain versions are kernels/hashtable/ref.py and core/hashing.py's
// config_hash_ref; every body equals them bit for bit (integer arithmetic
// only, uint32 products and sums wrap as the reference's).
//
// The table: S slots (a power of two), two uint32 hash lanes held in int64
// (SENTINEL in both when empty) and an int32 payload.  Key k's chain starts
// at
//   base(k) = fmix32(hi ^ (lo * 0x9E3779B1)) & (S - 1)
// and walks linearly for at most D probes.
//
// H1, one template (h1_kernel<BODY, L>), three bodies chosen at compile
// time:
//   keys  (lookup by keys): one thread a canonical key walks its chain
//         until it meets its key (found, payload), an empty slot or D
//         probes;
//   rows  (hash and lookup, the BFS level's): L threads (a warp, or a
//         block when the rows are too few to fill the card with warps) walk
//         one int32 candidate row, hash it to (hi, lo), make it canonical
//         (an invalid row -> the empty marker, a real key equal to the
//         marker -> (SENTINEL, SENTINEL - 1)) and probe its chain, 32 slots
//         at once, one a lane; an invalid row is not read;
//   hash  (config_hash): the rows body without the mask and the probe.
// A row is read once, 16 bytes a thread: rows are only 4-byte aligned in
// general (2,046 entries: 8,184 bytes apart), so the entries before the
// row's first 16-byte boundary and after its last are taken one a thread.
// config_hash is
//   y_j = mix((x_j + j * 0x9E3779B9) * 0x85EBCA6B),  mix(y) = y ^ (y >> 16)
//   h1 = sum_j y_j * P1^(w-1-j),  h2 = sum_j (y_j ^ 0x9E3779B9) * P2^(w-1-j)
// (mod 2^32), hi = fmix32(h1 ^ w), lo = fmix32(h2 + w * 0x9E3779B9).  A
// thread takes the 4-entry chunks c, c + L, c + 2L, ... of the row, so it
// runs Horner's rule over its own chunks with the step P^(4L), and scales
// its sum once by P^(w-1-j) of its last entry (the power tables that
// config_hash's constants hold on the card): no table is read in the loop.
// The sums are added over the row's threads by shuffles (and shared memory
// for a block).
//
// H2, claim-insert, shared by the inserts (on the visited table) and
// first_occurrence (on a table of its own).  Its rule, the reference's: of
// an equal-key group in one batch only the lowest-indexed candidate wins,
// and the table's layout is a function of the batch alone.  Each round
// (at most 2*D + 1):
//   phase A  every pending candidate reads its slot as the round found it:
//            its key -> duplicate; empty -> a claim, the minimum of the
//            claimers' indices on the slot's claim word; a foreign key ->
//            one probe further (D probes -> overflow);
//   (barrier)
//   phase B  a claimer whose index is the claim word writes its key and
//            payload into the slot; the others hold their position and
//            re-read the slot next round;
//   (barrier)  no candidate pending -> done.
// So a claim is decided by the minimum over the claimers, never by which
// compare-and-swap came first.  Three routes, picked by the sizes (K, S,
// D) and whether the table starts empty, before the launch
// (ops.claim_route); none takes over on another's failure:
//   cta      K <= 1024 (the inserts: K = F): one block, a thread a
//            candidate, __syncthreads between the phases; the table is in
//            device memory, the claim words in a shared-memory map keyed
//            by slot (2,048 entries), reset after each round;
//   cluster  a fresh table only, first_occurrence at the wave (K =
//            32,768, S = 65,536): one thread-block cluster of 16 blocks,
//            the most the card allows (a round's work is the blocks' load,
//            so more blocks run it faster); the slots' claim words (4 B a
//            slot) and the candidates' keys (8 B each) live in the blocks'
//            distributed shared memory, S/16 slots and K/16 keys a block
//            (32 KB at the wave), read and claimed across the cluster; a
//            candidate's key and state stay in its thread's registers.  One
//            cluster barrier a round: phase B moves into the next round's
//            phase A (claim_cluster_kernel's note); D at most 16,383.  The
//            table never exists in device memory;
//   grid     anything else: one cooperative launch over the card, grid
//            syncs between the phases, claim words and candidate states in
//            device memory.
// A fresh table of the cta and grid routes is filled by the kernel itself.
// Every route launches with cudaLaunchKernelEx on the caller's stream (no
// allocation, no host wait), so it can be captured into a CUDA graph.
//
// What bounds them: bytes.  H1's rows body reads each valid candidate row
// once (K x w x 4 bytes: 268 MB to 3.2 GB at the four full-width waves,
// 0.08 to 0.96 ms at 3.35 TB/s) and writes 17 bytes a candidate; its
// arithmetic (about 6 integer operations an entry) stays under that.  The
// keys body and H2 read 16-20 bytes a candidate and 16 a slot they touch:
// about 2 MB at the wave, a microsecond; there the rounds' barriers and
// dependent reads set the time, so H2 keeps the rounds on one SM (cta) or
// one cluster (cluster) and its table in shared memory.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr long long kSentinel = 0xFFFFFFFFLL;
constexpr uint32_t kSent32 = 0xFFFFFFFFu;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kMixMul = 0x85EBCA6Bu;
constexpr uint32_t kP1 = 0x01000193u;  // FNV prime
constexpr uint32_t kP2 = 0x85EBCA77u;
constexpr int kThreads = 256;          // H1's blocks, H2's grid route
constexpr int kCtaMax = 1024;          // H2's cta and cluster blocks
constexpr int kMap = 2 * kCtaMax;      // the cta route's claim map
constexpr int kItems = 8;              // candidates a cluster thread holds
constexpr int kClusterMax = 16;        // blocks of a cluster at most
// a cluster claim word: the round (15 bits) over the claimer's index
constexpr int kIndexBits = 17;
constexpr uint32_t kIndexMask = (1u << kIndexBits) - 1;
constexpr uint32_t kFree = 0xFFFFFFFFu;  // an unclaimed slot's claim word

enum H1Body : int { kKeys = 0, kRows = 1, kHash = 2 };
enum H2Route : int { kCta = 0, kCluster = 1, kGrid = 2 };

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

// ---------------------------------------------------------------------------
// H1
// ---------------------------------------------------------------------------

struct H1Args {
  const long long* s_hi;  // (S,) the table (keys and rows bodies)
  const long long* s_lo;
  const int* s_pay;
  const long long* keys_hi;  // (K,) canonical keys (keys body)
  const long long* keys_lo;
  const int* rows;           // (K, w) int32 candidate rows (rows, hash)
  const long long* p1;       // (w,) P1^(w-1-j), P2^(w-1-j) mod 2^32
  const long long* p2;
  const bool* valid;         // (K,) keys, rows
  long long* hi;             // (K,) lanes out (rows, hash)
  long long* lo;
  bool* found;               // (K,) keys, rows
  int* payload;              // (K,) keys
  int K;
  int w;
  long long S;
  int D;
  uint32_t step1;            // P1^(4L), P2^(4L): Horner's step over chunks
  uint32_t step2;
  unsigned long long* launches;
};

__device__ __forceinline__ uint32_t mix_entry(int x, uint32_t j) {
  const uint32_t y = ((uint32_t)x + j * kGolden) * kMixMul;
  return y ^ (y >> 16);
}

// Horner's step over one 4-entry chunk starting at entry j.
__device__ __forceinline__ void chunk(int4 v, uint32_t j, uint32_t step1,
                                      uint32_t step2, uint32_t& a1,
                                      uint32_t& a2) {
  const uint32_t y0 = mix_entry(v.x, j), y1 = mix_entry(v.y, j + 1),
                 y2 = mix_entry(v.z, j + 2), y3 = mix_entry(v.w, j + 3);
  const uint32_t c1 = ((y0 * kP1 + y1) * kP1 + y2) * kP1 + y3;
  const uint32_t c2 = (((y0 ^ kGolden) * kP2 + (y1 ^ kGolden)) * kP2 +
                       (y2 ^ kGolden)) * kP2 + (y3 ^ kGolden);
  a1 = a1 * step1 + c1;
  a2 = a2 * step2 + c2;
}

// Thread t's part (of L) of both polynomial sums of one row.
template <int L>
__device__ __forceinline__ void row_sums(const int* __restrict__ row, int w,
                                         int t, const H1Args& a, uint32_t& s1,
                                         uint32_t& s2) {
  const int head = min(w, (int)(((16u - ((uintptr_t)row & 15u)) & 15u) >> 2));
  const int nch = (w - head) >> 2;
  const int4* body = reinterpret_cast<const int4*>(row + head);
  uint32_t a1 = 0, a2 = 0;
  int last = -1;
  int c = t;
  for (; c + 3 * L < nch; c += 4 * L) {
    const int4 v0 = __ldcs(body + c);
    const int4 v1 = __ldcs(body + c + L);
    const int4 v2 = __ldcs(body + c + 2 * L);
    const int4 v3 = __ldcs(body + c + 3 * L);
    chunk(v0, head + 4 * c, a.step1, a.step2, a1, a2);
    chunk(v1, head + 4 * (c + L), a.step1, a.step2, a1, a2);
    chunk(v2, head + 4 * (c + 2 * L), a.step1, a.step2, a1, a2);
    chunk(v3, head + 4 * (c + 3 * L), a.step1, a.step2, a1, a2);
    last = c + 3 * L;
  }
  for (; c < nch; c += L) {
    chunk(__ldcs(body + c), head + 4 * c, a.step1, a.step2, a1, a2);
    last = c;
  }
  s1 = s2 = 0;
  if (last >= 0) {
    const int j = head + 4 * last + 3;
    s1 = a1 * (uint32_t)a.p1[j];
    s2 = a2 * (uint32_t)a.p2[j];
  }
  // the entries before the first 16-byte boundary and after the last chunk
  const int tail0 = head + 4 * nch;
  const int j = t < head ? t : tail0 + t - head;
  if (t < head + (w - tail0)) {
    const uint32_t y = mix_entry(__ldcs(row + j), (uint32_t)j);
    s1 += y * (uint32_t)a.p1[j];
    s2 += (y ^ kGolden) * (uint32_t)a.p2[j];
  }
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The chain of (h, l) walked 32 slots at once, a slot a lane: the first
// slot (in probe order) that holds the key or is empty ends it.
__device__ __forceinline__ bool warp_probe(const H1Args& a, uint32_t h,
                                           uint32_t l, int lane) {
  const long long mask = a.S - 1;
  const long long b = base_slot(h, l, mask);
  for (int p0 = 0; p0 < a.D; p0 += 32) {
    const int p = p0 + lane;
    bool match = false, stop = false;
    if (p < a.D) {
      const long long s = (b + p) & mask;
      const long long ch = a.s_hi[s], cl = a.s_lo[s];
      match = ch == (long long)h && cl == (long long)l;
      stop = match || (ch == kSentinel && cl == kSentinel);
    }
    const unsigned ends = __ballot_sync(0xffffffffu, stop);
    if (ends) return __shfl_sync(0xffffffffu, match, __ffs(ends) - 1);
  }
  return false;
}

template <int BODY, int L>
__global__ void __launch_bounds__(kThreads) h1_kernel(H1Args a) {
  // one launch counted on the card (kernels/launch_counts.py)
  if (a.launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(a.launches, 1ull);
  if constexpr (BODY == kKeys) {
    const long long mask = a.S - 1;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < a.K; i += (long long)gridDim.x * blockDim.x) {
      bool f = false;
      int pay = -1;
      if (a.valid[i]) {
        const long long h = a.keys_hi[i], l = a.keys_lo[i];
        const long long b = base_slot(h, l, mask);
        for (int p = 0; p < a.D; ++p) {
          const long long s = (b + p) & mask;
          const long long ch = a.s_hi[s], cl = a.s_lo[s];
          if (ch == h && cl == l) {
            f = true;
            pay = a.s_pay[s];
            break;
          }
          if (ch == kSentinel && cl == kSentinel) break;
        }
      }
      a.found[i] = f;
      a.payload[i] = pay;
    }
  } else {
    constexpr int kRowsPerBlock = kThreads / L;
    __shared__ uint32_t part[2][kThreads / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int t = threadIdx.x % L;
    const long long r =
        (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / L;
    const bool live = r < a.K;
    bool v = live;
    if constexpr (BODY == kRows) v = live && a.valid[r];
    uint32_t s1 = 0, s2 = 0;
    if (v) row_sums<L>(a.rows + r * a.w, a.w, t, a, s1, s2);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if constexpr (L > 32) {
      // one row a block: the warps' sums through shared memory to warp 0
      if (lane == 0) {
        part[0][warp] = s1;
        part[1][warp] = s2;
      }
      __syncthreads();
      if (warp != 0) return;
      s1 = warp_sum(lane < L / 32 ? part[0][lane] : 0u);
      s2 = warp_sum(lane < L / 32 ? part[1][lane] : 0u);
    }
    if (!live) return;
    uint32_t hi = fmix32(s1 ^ (uint32_t)a.w);
    uint32_t lo = fmix32(s2 + (uint32_t)a.w * kGolden);
    if constexpr (BODY == kRows) {
      if (!v) {
        hi = lo = kSent32;
      } else if (hi == kSent32 && lo == kSent32) {
        lo = kSent32 - 1;
      }
    }
    if (lane == 0) {
      a.hi[r] = hi;
      a.lo[r] = lo;
    }
    if constexpr (BODY == kRows) {
      const bool f = v && warp_probe(a, hi, lo, lane);
      if (lane == 0) a.found[r] = f;
    }
  }
}

uint32_t pow32(uint32_t b, unsigned long long e) {
  uint32_t out = 1;
  for (; e; e >>= 1, b *= b)
    if (e & 1) out *= b;
  return out;
}

template <int BODY>
int launch_rows(H1Args& a, int L, cudaStream_t stream) {
  a.step1 = pow32(kP1, 4ull * L);
  a.step2 = pow32(kP2, 4ull * L);
  const long long per = kThreads / L;
  const long long blocks = (a.K + per - 1) / per;
  if (L == 32)
    h1_kernel<BODY, 32><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  else if (L == kThreads)
    h1_kernel<BODY, kThreads><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// H2
// ---------------------------------------------------------------------------

struct ClaimArgs {
  long long* s_hi;       // (S,) the table; null on a fresh cluster table
  long long* s_lo;
  int* s_pay;
  const long long* hi;   // (K,) canonical keys
  const long long* lo;
  const bool* pending;
  const int* payload;    // (K,) or null: payload 0
  int* claim;            // grid route's scratch: (S,) claim words,
  int* probe;            // (K,) probe counts,
  unsigned char* state;  // (K,) candidate states,
  int* count;            // (3,) per-round pending counts
  bool* won;
  bool* dup;
  bool* overflow;        // () any candidate overflowed
  int K;
  long long S;
  int D;
  int fresh;             // the table starts empty (SENTINEL, payload 0)
  unsigned long long* launches;
};

__device__ __forceinline__ int pay_of(const ClaimArgs& a, long long i) {
  return a.payload != nullptr ? a.payload[i] : 0;
}

// The cta route's map entry of slot s (inserted if new): linear probing in
// kMap entries, at most kCtaMax slots a round.
__device__ __forceinline__ int map_entry(uint32_t* keys, uint32_t s) {
  int e = (int)(fmix32(s) & (kMap - 1));
  for (;;) {
    const uint32_t prev = atomicCAS(keys + e, kSent32, s);
    if (prev == kSent32 || prev == s) return e;
    e = (e + 1) & (kMap - 1);
  }
}

__global__ void __launch_bounds__(kCtaMax) claim_cta_kernel(ClaimArgs a) {
  // one launch counted on the card (kernels/launch_counts.py)
  if (a.launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(a.launches, 1ull);
  __shared__ uint32_t map_slot[kMap];
  __shared__ int map_min[kMap];
  const long long mask = a.S - 1;
  for (int e = threadIdx.x; e < kMap; e += blockDim.x) {
    map_slot[e] = kSent32;
    map_min[e] = INT_MAX;
  }
  if (a.fresh) {
    for (long long s = threadIdx.x; s < a.S; s += blockDim.x) {
      a.s_hi[s] = kSentinel;
      a.s_lo[s] = kSentinel;
      a.s_pay[s] = 0;
    }
  }
  const int i = threadIdx.x;
  unsigned char st = kIdle;
  long long h = 0, l = 0, b = 0, s = 0;
  int p = 0, e = -1;
  if (i < a.K && a.pending[i]) {
    st = kPending;
    h = a.hi[i];
    l = a.lo[i];
    b = base_slot(h, l, mask);
  }
  __syncthreads();
  const int rounds = 2 * a.D + 1;
  for (int r = 0; r < rounds; ++r) {
    // phase A: read the slot as this round found it; claim, match or move
    if (st == kPending) {
      s = (b + p) & mask;
      const long long ch = a.s_hi[s], cl = a.s_lo[s];
      if (ch == h && cl == l) {
        st = kDup;
      } else if (ch == kSentinel && cl == kSentinel) {
        e = map_entry(map_slot, (uint32_t)s);
        atomicMin(map_min + e, i);
        st = kClaiming;
      } else if (++p >= a.D) {
        st = kOverflow;
      }
    }
    __syncthreads();
    // phase B: the lowest claimer of each slot writes it; the rest hold
    if (st == kClaiming) {
      if (map_min[e] == i) {
        a.s_hi[s] = h;
        a.s_lo[s] = l;
        a.s_pay[s] = pay_of(a, i);
        st = kWon;
      } else {
        st = kPending;
      }
    }
    __syncthreads();
    if (e >= 0) {
      map_slot[e] = kSent32;
      map_min[e] = INT_MAX;
      e = -1;
    }
    if (__syncthreads_count(st == kPending) == 0) break;
  }
  if (i < a.K) {
    a.won[i] = st == kWon;
    a.dup[i] = st == kDup;
  }
  const int ovf = __syncthreads_or(st == kOverflow);
  if (threadIdx.x == 0) *a.overflow = ovf != 0;
}

__device__ __forceinline__ uint32_t pack(unsigned char st, int p) {
  return ((uint32_t)st << 24) | (uint32_t)p;
}
__device__ __forceinline__ unsigned char state_of(uint32_t c) {
  return (unsigned char)(c >> 24);
}
__device__ __forceinline__ int probe_of(uint32_t c) {
  return (int)(c & 0xFFFFFFu);
}

// The cluster route claims into a fresh table only, so a slot holds no key
// of its own: its claim word says all.  It keeps one barrier a round.  A
// slot's claim word is claimed with the round in its high bits and the
// claimer's index in its low ones, so it needs no reset: a reader takes a
// word of this round as an empty slot (the claims of the round it reads
// in), a word of an earlier round as a slot taken by the batch, whose key
// can never be the reader's (equal keys share a chain, so they claim
// together).  A claimer reads its word in the next round: won when it
// holds its index, else the winner's key (from the block that holds that
// candidate) makes it a duplicate or sends it one probe further, as the
// plain version's re-read of the lost slot does; a pass after the last
// round resolves the last round's claims.
__global__ void __launch_bounds__(kCtaMax) claim_cluster_kernel(ClaimArgs a) {
  // one launch counted on the card (kernels/launch_counts.py)
  if (a.launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(a.launches, 1ull);
  cg::cluster_group cluster = cg::this_cluster();
  // [the block's candidates' keys | its slots' claim words]
  extern __shared__ uint2 ckeys[];
  __shared__ int busy[2][kClusterMax];  // a block's active flag, by round
  __shared__ int flag;                  // a candidate of the block overflowed
  const int nc = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const long long slice = a.S / nc;     // a power of two
  const int shift = __ffsll(slice) - 1;
  const long long mask = a.S - 1;
  // candidates q*nloc .. (q+1)*nloc - 1, item k of thread t at
  // t + k*blockDim.x; their keys and states stay in registers
  const int nloc = (a.K + nc - 1) / nc;
  const int first = q * nloc;
  const int mine = max(0, min(nloc, a.K - first));
  uint32_t* words = reinterpret_cast<uint32_t*>(ckeys + nloc);
  for (long long s = threadIdx.x; s < slice; s += blockDim.x)
    words[s] = kFree;
  if (threadIdx.x == 0) flag = 0;
  uint32_t cs[kItems], kh[kItems], kl[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int x = threadIdx.x + k * blockDim.x;
    const bool live = x < mine && a.pending[first + x];
    cs[k] = pack(live ? kPending : kIdle, 0);
    kh[k] = live ? (uint32_t)a.hi[first + x] : 0u;
    kl[k] = live ? (uint32_t)a.lo[first + x] : 0u;
    if (x < mine) ckeys[x] = make_uint2(kh[k], kl[k]);
  }
  cluster.sync();
  const int rounds = 2 * a.D + 1;
  for (int r = 0; r <= rounds; ++r) {
    const bool last = r == rounds;   // resolve the last round's claims only
    int active = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const unsigned char st = state_of(cs[k]);
      if (st != kPending && st != kClaiming) continue;
      const int i = first + threadIdx.x + k * blockDim.x;
      int p = probe_of(cs[k]);
      const long long s = (base_slot(kh[k], kl[k], mask) + p) & mask;
      const int owner = (int)(s >> shift);
      const long long ls = s & (slice - 1);
      uint32_t* word = cluster.map_shared_rank(words, owner) + ls;
      bool advance = false;
      if (st == kClaiming) {
        const uint32_t w = *word & kIndexMask;
        if (w == (uint32_t)i) {
          cs[k] = pack(kWon, p);
        } else if (last) {
          cs[k] = pack(kPending, p);   // unresolved, as the plain version
        } else {
          const uint2 wk = cluster.map_shared_rank(
              ckeys, (int)(w / (uint32_t)nloc))[w % (uint32_t)nloc];
          if (wk.x == kh[k] && wk.y == kl[k])
            cs[k] = pack(kDup, p);
          else
            advance = true;
        }
      } else if (!last) {
        // read the slot as this round found it: a word of an earlier
        // round is a slot taken by the batch; a free word, or one of this
        // round's claims, an empty slot
        const uint32_t v = *word;
        if (v != kFree && (v >> kIndexBits) < (uint32_t)r) {
          advance = true;
        } else {
          atomicMin(word, ((uint32_t)r << kIndexBits) | (uint32_t)i);
          cs[k] = pack(kClaiming, p);
          ++active;
        }
      }
      if (advance) {
        if (++p >= a.D) {
          cs[k] = pack(kOverflow, p);
          flag = 1;
        } else {
          cs[k] = pack(kPending, p);
          ++active;
        }
      }
    }
    if (last) break;
    // every block's active flag into every block (stores, no round trip)
    const int n = __syncthreads_count(active > 0);
    if (threadIdx.x < nc)
      *cluster.map_shared_rank(&busy[r & 1][q], (int)threadIdx.x) = n > 0;
    cluster.sync();
    int any = 0;
    for (int c = 0; c < nc; ++c) any |= busy[r & 1][c];
    if (!any) break;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int x = threadIdx.x + k * blockDim.x;
    if (x < mine) {
      a.won[first + x] = state_of(cs[k]) == kWon;
      a.dup[first + x] = state_of(cs[k]) == kDup;
    }
  }
  // any overflow, gathered in block 0; no block leaves while another may
  // still read its shared memory
  if (threadIdx.x == 0 && flag) atomicOr(cluster.map_shared_rank(&flag, 0), 1);
  cluster.sync();
  if (q == 0 && threadIdx.x == 0) *a.overflow = flag != 0;
}

__global__ void __launch_bounds__(kThreads) claim_grid_kernel(ClaimArgs a) {
  // one launch counted on the card (kernels/launch_counts.py)
  if (a.launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(a.launches, 1ull);
  cg::grid_group grid = cg::this_grid();
  const long long mask = a.S - 1;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  __shared__ int block_pending;

  for (long long s = tid; s < a.S; s += nthreads) {
    a.claim[s] = INT_MAX;
    if (a.fresh) {
      a.s_hi[s] = kSentinel;
      a.s_lo[s] = kSentinel;
      a.s_pay[s] = 0;
    }
  }
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
          a.s_pay[s] = pay_of(a, i);
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
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, claim_grid_kernel,
                                                kThreads, 0);
  long long want = (work + kThreads - 1) / kThreads;
  long long most = (long long)sms * (per > 0 ? per : 1);
  if (want < 1) want = 1;
  return (int)(want < most ? want : most);
}

int launch_claim(int route, int ctas, ClaimArgs& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (route == kCta) {
    int threads = (a.K + 31) / 32 * 32;
    cfg.gridDim = dim3(1);
    cfg.blockDim = dim3(threads < 32 ? 32 : threads);
    return (int)cudaLaunchKernelEx(&cfg, claim_cta_kernel, a);
  }
  if (route == kCluster) {
    const long long slice = a.S / ctas;
    const long long nloc = (a.K + ctas - 1) / ctas;
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(kCtaMax);
    cfg.dynamicSmemBytes = (size_t)(nloc * sizeof(uint2)
                                    + slice * sizeof(uint32_t));
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, claim_cluster_kernel, a);
  }
  const long long work = (long long)a.K > a.S ? (long long)a.K : a.S;
  cfg.gridDim = dim3(coop_grid(work));
  cfg.blockDim = dim3(kThreads);
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, claim_grid_kernel, a);
}

}  // namespace

// C entry points: launch on `stream` (PyTorch's current stream), allocate
// nothing, return the launch's error (0 on success).  Keys hi/lo (K,) int64
// holding uint32 lanes, canonical; the table s_hi/s_lo (S,) int64, s_pay
// (S,) int32, S a power of two; D probes at most.  `launches` (one uint64
// counter, or null) gets one added on the card when the kernel runs.

// Once a process and device, before the first claim: lets the cluster
// route's blocks take up to `smem` bytes of dynamic shared memory and its
// clusters 16 blocks.
extern "C" int hashtable_setup(int smem) {
  cudaFuncSetAttribute(claim_cluster_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(claim_cluster_kernel,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return (int)cudaGetLastError();
}

// H1's keys body: found (K,) bool and payload (K,) int32 (-1 when absent).
extern "C" int hashtable_lookup(const void* s_hi, const void* s_lo,
                                const void* s_pay, const void* hi,
                                const void* lo, const void* valid,
                                void* found, void* payload, int K,
                                long long S, int D, void* launches,
                                void* stream) {
  if (K <= 0) return 0;
  if (S <= 0 || (S & (S - 1)) != 0 || D < 0) return (int)cudaErrorInvalidValue;
  H1Args a = {};
  a.s_hi = (const long long*)s_hi;
  a.s_lo = (const long long*)s_lo;
  a.s_pay = (const int*)s_pay;
  a.keys_hi = (const long long*)hi;
  a.keys_lo = (const long long*)lo;
  a.valid = (const bool*)valid;
  a.found = (bool*)found;
  a.payload = (int*)payload;
  a.K = K;
  a.S = S;
  a.D = D;
  a.launches = (unsigned long long*)launches;
  const int blocks = (K + kThreads - 1) / kThreads;
  h1_kernel<kKeys, 32><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// H1's rows body (hash = 0: hash, canonicalise under `valid`, probe; found
// (K,) bool out) or hash body (hash = 1: the raw lanes only; valid, the
// table and found unused): rows (K, w) int32, p1/p2 (w,) int64 power
// tables, lanes hi/lo (K,) int64 out; `threads` a row: 32 or 256.
extern "C" int hashtable_rows(int hash, const void* rows, const void* p1,
                              const void* p2, const void* valid,
                              const void* s_hi, const void* s_lo, void* hi,
                              void* lo, void* found, int K, int w,
                              long long S, int D, int threads,
                              void* launches, void* stream) {
  if (K <= 0) return 0;
  if (w < 0 || D < 0 || (!hash && (S <= 0 || (S & (S - 1)) != 0)))
    return (int)cudaErrorInvalidValue;
  H1Args a = {};
  a.s_hi = (const long long*)s_hi;
  a.s_lo = (const long long*)s_lo;
  a.rows = (const int*)rows;
  a.p1 = (const long long*)p1;
  a.p2 = (const long long*)p2;
  a.valid = (const bool*)valid;
  a.hi = (long long*)hi;
  a.lo = (long long*)lo;
  a.found = (bool*)found;
  a.K = K;
  a.w = w;
  a.S = S;
  a.D = D;
  a.launches = (unsigned long long*)launches;
  return hash ? launch_rows<kHash>(a, threads, (cudaStream_t)stream)
              : launch_rows<kRows>(a, threads, (cudaStream_t)stream);
}

// H2: claims the pending candidates into the table (payload (K,) int32, or
// null for 0, goes with each winner); won, dup (K,) bool and overflow ()
// bool out.  route 0 (cta), 1 (cluster of `ctas` blocks; fresh tables
// only) or 2 (grid); fresh: the table starts empty (the cluster route's
// needs no table: s_* may be null).  Scratch, the grid route's only: claim (S,) int32,
// probe (K,) int32, state (K,) uint8, count (3,) int32.
extern "C" int hashtable_claim(int route, int ctas, int fresh, void* s_hi,
                               void* s_lo, void* s_pay, const void* hi,
                               const void* lo, const void* pending,
                               const void* payload, void* claim, void* probe,
                               void* state, void* count, void* won, void* dup,
                               void* overflow, int K, long long S, int D,
                               void* launches, void* stream) {
  if (S <= 0 || (S & (S - 1)) != 0 || D < 0 || K < 0 ||
      (route == kCta && K > kCtaMax) ||
      (route == kCluster && (ctas < 1 || ctas > kClusterMax ||
                             (ctas & (ctas - 1)) != 0 || !fresh ||
                             S < ctas || 2LL * D + 1 >= (1LL << (32 - kIndexBits)) ||
                             K > (1 << kIndexBits) ||
                             (K + ctas - 1) / ctas > kItems * kCtaMax)) ||
      route < kCta || route > kGrid)
    return (int)cudaErrorInvalidValue;
  ClaimArgs a{(long long*)s_hi, (long long*)s_lo, (int*)s_pay,
              (const long long*)hi, (const long long*)lo,
              (const bool*)pending, (const int*)payload, (int*)claim,
              (int*)probe, (unsigned char*)state, (int*)count, (bool*)won,
              (bool*)dup, (bool*)overflow, K, S, D, fresh,
              (unsigned long long*)launches};
  return launch_claim(route, ctas, a, (cudaStream_t)stream);
}

// H2's cooperative grid (blocks of kThreads) for `work` candidates or
// slots, for the wrapper's records.
extern "C" int hashtable_claim_blocks(long long work) {
  return coop_grid(work);
}
