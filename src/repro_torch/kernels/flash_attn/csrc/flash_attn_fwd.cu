// Kernel B8: forward softmax attention with GQA, causal and KV-length
// masks, by an online softmax over KV tiles.
//
// Replaces src/repro/kernels/flash_attn/kernel.py::flash_attention_pallas
// (body _kernel, kernel.py:29; pallas_call, kernel.py:117).  Same function:
//   o[b,h,i] = sum_j softmax_j(q[b,h,i]·scale · k[b,h//group,j]) v[b,h//group,j]
// over the keys j < kv_len[b] (and j <= i when causal); masked
// probabilities are exactly 0 and a row with no valid key is exactly 0.
// Inputs q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) contiguous, f32 or bf16,
// unpadded; kv_len (B,) int32 (clipped to Skv here and by the wrapper).
// The output has q's type.  Two bodies, picked by type and head dim (no
// fallback between them; flash_attn_fwd_tensor_cores says which runs):
//
// The tensor-core body: bf16 at D in {64, 128} (SmolLM-360M's 64,
// Command-R's and Qwen2-VL's 128).  It took those inputs from the FFMA
// body of the first port, which ran them at 3.5 ms at the serving
// prefill's launch, 59x its bound (f32 FFMA at a quarter of that pipe's
// peak, f32 tiles in shared memory at 3 loads per 8 FFMA, plain
// per-element loads, 8% of its work on padded rows).
// * What bounds it: 4·D FLOPs a valid (query, key) pair and head, read
//   once: at the serving prefill (B=8, Hq=15, Hkv=5, S=1960, D=64, causal)
//   59 GFLOP, 0.060 ms at the bf16 tensor-core peak, against 0.012 ms of
//   bytes: operations bind.  Past the tensor cores, the softmax's
//   exponentials (one MUFU op a pair, 16 a clock an SM) are the next wall.
// * Tiles: a block of 384 threads per (q tile of BQ = 128 rows, query
//   head, batch row): warpgroup 0 is the producer (one thread issues TMA),
//   warpgroups 1 and 2 are consumers of 64 rows each.  The grid is (Hq, B,
//   q tiles) with the q tile taken in reverse, so the longest causal rows
//   start first.  KV tiles are BK = 128 keys at D = 64, 64 at D = 128
//   (S, P and O of 128 keys at D = 128 do not fit 240 registers: ptxas
//   serialised the wgmmas and spilled).
// * Loads: TMA into 128-byte-swizzled shared memory (the layout wgmma's
//   descriptors read), each tile in panels of 64 columns.  Q is loaded once
//   a block; K and V go through a ring of 3 stages, each with its own full
//   barrier (S = Q·Kᵀ starts before V has landed) and one empty barrier
//   the two consumers release.  The tensor maps are 3-D, (D, S, B·H), so
//   rows past S read as zeros, never as the next head's rows: the wrapper
//   pads nothing.  They are encoded on the host (cuTensorMapEncodeTiled
//   through cudaGetDriverEntryPoint: no -lcuda) and passed as
//   __grid_constant__ parameters.
// * S = Q·Kᵀ: wgmma m64nBKk16, bf16 in, f32 accumulate, both operands
//   from shared memory, K-major.  The scale times log2(e) multiplies the f32
//   scores and the exponentials are exp2 (the reference scales q first,
//   kernel.py:50: the two differ by f32 rounding only).
// * Softmax: online, in registers, on the accumulator's own fragment (a
//   thread holds 2 rows; a row's max and sum reduce over a quad by
//   shuffles; each thread keeps a partial row sum until the end).  Masks
//   are computed only on tiles that reach kv_len or cross the causal
//   diagonal; there masked scores are -1e30 and their probabilities are set
//   to exactly 0 after the exponential, so a row with no valid key keeps
//   l = 0 and ends as 0 (kernel.py:59-68, :82).
// * O += P·V: wgmma m64nDk16 with P from registers (the f32 fragment of S
//   maps onto the bf16 A fragment with no shuffles) and V from shared
//   memory, MN-major (the descriptor's transpose bit).  P goes in as two
//   bf16 terms, hi = bf16(p) and lo = bf16(p - hi), two wgmmas a k-step:
//   P in one bf16 term misses the kernel's tolerance against its plain
//   version (atol 1e-3, rtol 8e-3 on bf16 outputs) on about 1e-5 of the
//   elements at the serving launch (outputs near 0, few keys); hi + lo
//   carries 16 bits of p.  It costs 1.5x the tensor work of one term.
// * Epilogue: O / l where l > 0, else 0, cast to bf16, plain stores of
//   bf16 pairs; rows past Sq are not written.
// * Registers: the producer drops to 24 a thread, the consumers rise to
//   240 (setmaxnreg).  -Xptxas -v (CUDA 12.8, sm_90a; chip_smoke.py prints
//   it): 168 registers at entry for both instantiations; D = 64 spills 4
//   bytes (16 bytes of reloads), D = 128 nothing.  Shared memory: 16 KiB
//   of Q and 3 x 32 KiB of K/V at D = 64, 32 + 3 x 32 KiB at D = 128 (113
//   and 129 KiB with alignment), 80 bytes of barriers: one block an SM,
//   held there by registers (384 x 168).
// * Measured (H100 80GB HBM3, 700 W; PERF.md): 0.327 ms at the serving
//   launch, 180 TFLOP/s of the bound's work, 1.8x SDPA; at D = 128 (q (1,
//   64, 4096, 128), GQA 8) 316 TFLOP/s.  What holds it there is not split
//   by a trace: per pair it runs one exp2 and, for P's two terms, two
//   conversions to bf16 beside a 64-wide dot, and a consumer waits for its
//   own S before its softmax and for its P·V before the next S (the two
//   consumers overlap each other, not their own stages).
//
// The split-TF32 body: f32 at D in {16, 32, 64, 128} and bf16 at D in
// {16, 32}, on the tensor cores through mma.sync m16n8k8 TF32 with f32
// accumulation.  It replaces the FFMA body of the first port (every
// product on the f32 pipe, scores through shared memory, scalar
// synchronous loads: 1.11 ms at the f32 serving launch, 1.8x SDPA on k/v
// repeated to every head).
// * Why split: one TF32 product (10 mantissa bits) misses the f32
//   contract, 2e-5 against the plain version and 1e-4 on logits, by 25-50x
//   (tests/test_torch_flash_attn.py emulates it).  So every f32 operand x
//   is split as hi = tf32(x), rounded to nearest, and lo = x - hi, exact in
//   f32, of which the tensor core reads the top 19 bits (it ignores the low
//   13, as CUTLASS's fast-f32 GEMMs rely on); a product a·b runs as
//   lo_a·hi_b + hi_a·lo_b + hi_a·hi_b into one accumulator (lo·lo, about
//   2^-22 of it, is dropped).  bf16 values are exact in TF32: Q·Kᵀ then
//   takes one product and P·V two (P's lo and hi times V).  No f32 value
//   enters a product as a single TF32 term.
// * What bounds it: 4·D FLOPs a valid (query, key) pair and head; split
//   three ways, 12·D TF32 FLOPs.  At the f32 serving launch (B=2, Hq=15,
//   Hkv=5, S=1960, D=64, causal) that is 44.3 GFLOP, 0.0895 ms at the 495
//   TFLOP/s TF32 peak, against 0.2203 ms for the 14.76 GFLOP on the f32
//   pipe (67 TFLOP/s) and 0.009 ms of bytes: the split products bind.
// * Tiles: a block of 32·WARPS threads (WARPS = 4) per (q tile of 16·WARPS
//   rows, query head, batch row), 16 query rows a warp; the grid is (Hq,
//   B, q tiles) with the q tile taken in reverse (longest causal rows
//   first).  A warp keeps its scores, its running max and sum and its
//   output in registers: the scores never touch shared memory, and no
//   barrier separates the softmax from P·V.  KV tiles are BK = 64 keys (32
//   at D = 128), in 2 stages of shared memory.
// * Loads: cp.async 16-byte copies of each K and V tile, issued a tile
//   ahead; rows at or past kv_len are filled with zeros (no read).  Rows
//   are padded to D + 8 elements for K (and Q) and D + 4 f32 (D + 8 bf16)
//   for V, so that a warp's fragment reads hit 32 distinct banks.  Q's
//   fragments are read once from device memory into registers (split into
//   hi and lo) at D <= 64; at D = 128 Q is staged in shared memory and its
//   fragments re-read and split each tile (O alone is 64 registers there).
//   K and V are split per fragment, as they are read.
// * S = Q·Kᵀ: the sum over d runs in any order, so k-index t of a k-step
//   takes dim 2t and t + 4 takes dim 2t + 1 of its 8 dims: Q's and K's
//   fragments are pairs of neighbouring floats (one 8-byte load).
// * P·V with no shuffles: in the m16n8 accumulator a thread holds keys 2t
//   and 2t + 1 of each 8; taking k-index t as key 2t and t + 4 as key
//   2t + 1, S's c0..c3 are P's a0, a2, a1, a3 and V's B fragment reads
//   rows 2t and 2t + 1 (the sum over keys does not care about their order).
// * Softmax: as the tensor-core body (a row's max and sum over a quad by
//   shuffles, exp2f with the scale times log2(e) on the scores, masks only
//   on tiles that reach kv_len or cross a warp's diagonal, -1e30 scores and
//   exactly-0 probabilities); a warp skips the tiles above its own
//   diagonal.  Epilogue: O / l (IEEE division) where l > 0, else 0, stored
//   as pairs in q's type; rows past Sq are not written.
// * Registers (-Xptxas -v, CUDA 12.8, sm_90a): 124 / 152 / 205 / 165 at
//   f32 D 16 / 32 / 64 / 128, 102 / 128 at bf16 D 16 / 32, no spill; at f32
//   D 64 two blocks an SM (registers; shared memory, 70 KiB a block, would
//   allow three).  Capping registers for three blocks spilled and ran
//   slower, and 8 warps a block ran 7% slower;
//   splitting K and V once a tile into hi and lo tiles in shared memory,
//   a third barrier a tile and twice the fragment loads, ran slower.
// * Measured (H100 80GB HBM3, 700 W; chip_smoke.py phase 16 and
//   probes/attn_device_times.py; PERF.md): 0.275-0.282 ms on the card at
//   the f32 serving launch, 3.1x its bound, 52 TFLOP/s of f32 work (161
//   of split TF32 work), against 1.12 ms for the FFMA body in turns (4.0x)
//   and 0.62 ms for SDPA on k/v repeated to every head; an f32 SmolLM-360M
//   prefill of 2 x 1960 tokens takes 76.0 ms of device time, 102.4 with the
//   FFMA body.

#include <cuda.h>  // CUtensorMap types only; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

// ---------------------------------------------------------------------------
// The split-TF32 body (f32; bf16 at D in {16, 32})
// ---------------------------------------------------------------------------

namespace tf32 {

constexpr int WARPS = 4;  // 16 query rows each; 8 ran 7% slower
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block
constexpr int STAGES = 2;       // K/V tiles in flight
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int D>
struct Cfg {
  static constexpr bool WIDE = std::is_same<T, float>::value;  // f32: split
  static constexpr int BK = D == 128 ? 32 : 64;  // keys per KV tile
  static constexpr bool Q_REGS = D <= 64;  // Q's fragments kept in registers
  static constexpr int ES = sizeof(T);
  static constexpr int KS = D + 8;                 // K (and Q) row stride
  static constexpr int VS = WIDE ? D + 4 : D + 8;  // V row stride
  static constexpr int K_BYTES = BK * KS * ES;
  static constexpr int STAGE = K_BYTES + BK * VS * ES;
  static constexpr int Q_OFF = STAGES * STAGE;
  static constexpr int SMEM = Q_OFF + (Q_REGS ? 0 : BQ * KS * ES);
  static_assert(KS * ES % 16 == 0 && VS * ES % 16 == 0, "16-byte rows");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously; zeros (and no
// read) when `bytes` is 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one group of this thread's copies is in flight.
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// x = hi + lo: hi is x rounded to nearest (ties away from zero) to TF32's
// 10 mantissa bits, lo the exact rest (the tensor core reads its top 19
// bits).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a·b, m16n8k8, TF32 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring elements, and one element, as f32 (bf16 widened).
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float one(const float* p) { return *p; }
__device__ __forceinline__ float one(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// A fragment (a0..a3) of 16 rows x 8 k-indices from the pairs (k-index t,
// t + 4) of rows g and g + 8: as TF32 hi and lo terms (f32), or as the
// exact values (bf16: lo unused).
template <bool WIDE>
__device__ __forceinline__ void a_frag(float2 r0, float2 r8, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  if constexpr (WIDE) {
    split(r0.x, hi[0], lo[0]);
    split(r8.x, hi[1], lo[1]);
    split(r0.y, hi[2], lo[2]);
    split(r8.y, hi[3], lo[3]);
  } else {
    hi[0] = __float_as_uint(r0.x);
    hi[1] = __float_as_uint(r8.x);
    hi[2] = __float_as_uint(r0.y);
    hi[3] = __float_as_uint(r8.y);
  }
}

// d += a·b with B's two values b0, b1 (f32 or exact bf16): three products
// when both sides are f32, one when both are exact.
template <bool WIDE>
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], float b0,
                                          float b1) {
  if constexpr (WIDE) {
    uint32_t bh0, bl0, bh1, bl1;
    split(b0, bh0, bl0);
    split(b1, bh1, bl1);
    mma(d, al, bh0, bh1);
    mma(d, ah, bl0, bl1);
    mma(d, ah, bh0, bh1);
  } else {
    mma(d, ah, __float_as_uint(b0), __float_as_uint(b1));
  }
}

// Fragment coordinates (m16n8 accumulator): element i of a thread's tile j
// lies in row g + 8·(i >> 1) of its warp's 16 and in column 8·j + 2·t +
// (i & 1), with g = lane / 4 and t = lane % 4.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_attn_fwd_tf32_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const int* __restrict__ kv_len,
                               T* __restrict__ out, int Hq, int Hkv, int Sq,
                               int Skv, int causal, float scale_log2) {
  using C = Cfg<T, D>;
  constexpr bool WIDE = C::WIDE;
  constexpr int BK = C::BK, NK = BK / 8, ND = D / 8;
  constexpr int CPR = D * C::ES / 16;  // 16-byte chunks a row
  extern __shared__ __align__(16) uint8_t smem[];

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest rows first
  const int hk = h / (Hq / Hkv);                      // GQA
  const int len = min(kv_len[b], Skv);
  // Tiles from n_tiles on hold no valid key (all at or past kv_len, or, for
  // a causal mask, above every row of this block): skipping them is exact.
  const int k_end = causal ? min(len, q0 + BQ) : len;
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = q0 + 16 * warp;  // this warp's first query row
  // this warp's tiles: none past Sq, none above its last row when causal
  const int n_warp =
      w0 >= Sq ? 0 : causal ? min(n_tiles, (w0 + 16 + BK - 1) / BK) : n_tiles;

  const T* qb = q + (size_t)(b * Hq + h) * Sq * D;
  const uint8_t* kb =
      reinterpret_cast<const uint8_t*>(k + (size_t)(b * Hkv + hk) * Skv * D);
  const uint8_t* vb =
      reinterpret_cast<const uint8_t*>(v + (size_t)(b * Hkv + hk) * Skv * D);
  const uint32_t base = smem_u32(smem);

  // KV tile n (keys n·BK ...) into its stage; rows at or past len are zeros
  auto load_kv = [&](int n) {
    const uint32_t ks = base + (n % STAGES) * C::STAGE, vs = ks + C::K_BYTES;
    for (int i = tid; i < BK * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR, key = n * BK + r;
      const bool in = key < len;
      const size_t off = in ? (size_t)key * D * C::ES + c * 16 : 0;
      cp_async16(ks + (r * C::KS * C::ES + c * 16), kb + off, in ? 16 : 0);
      cp_async16(vs + (r * C::VS * C::ES + c * 16), vb + off, in ? 16 : 0);
    }
  };

  // Q's A fragments, k-step kk: dims 8kk + 2t (k-index t) and 8kk + 2t + 1
  // (t + 4) of rows w0 + g and w0 + g + 8
  uint32_t qh[C::Q_REGS ? ND : 1][4], ql[C::Q_REGS && WIDE ? ND : 1][4];
  if constexpr (C::Q_REGS) {
    const int ra = w0 + g, rb = w0 + g + 8;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const float2 x = ra < Sq ? pair(qb + (size_t)ra * D + 8 * kk + 2 * t)
                               : make_float2(0.f, 0.f);
      const float2 y = rb < Sq ? pair(qb + (size_t)rb * D + 8 * kk + 2 * t)
                               : make_float2(0.f, 0.f);
      a_frag<WIDE>(x, y, qh[kk], ql[WIDE ? kk : 0]);
    }
  } else if (n_tiles > 0) {
    // staged once, with the first KV tile; rows past Sq are zeros
    const uint8_t* qbytes = reinterpret_cast<const uint8_t*>(qb);
    for (int i = tid; i < BQ * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR;
      const bool in = q0 + r < Sq;
      const size_t off = in ? (size_t)(q0 + r) * D * C::ES + c * 16 : 0;
      cp_async16(base + C::Q_OFF + (r * C::KS * C::ES + c * 16),
                 qbytes + off, in ? 16 : 0);
    }
  }
  const T* Qs = reinterpret_cast<const T*>(smem + C::Q_OFF) +
                (16 * warp + g) * C::KS + 2 * t;

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this thread's part

  if (n_tiles > 0) load_kv(0);
  cp_async_commit();
  for (int n = 0; n < n_tiles; ++n) {
    if (n + 1 < n_tiles) load_kv(n + 1);
    cp_async_commit();
    cp_async_wait_1();  // tile n (and Q) has landed for this thread ...
    __syncthreads();    // ... and for every thread
    if (n < n_warp) {
      const int k0 = n * BK;
      const uint8_t* stage = smem + (n % STAGES) * C::STAGE;
      const T* Ks = reinterpret_cast<const T*>(stage);
      const T* Vs = reinterpret_cast<const T*>(stage + C::K_BYTES);

      // S = Q Kᵀ (16 x BK a warp, f32)
      float s[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        uint32_t ah[4], al[4];
        if constexpr (C::Q_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[i] = qh[kk][i];
            al[i] = ql[WIDE ? kk : 0][i];
          }
        } else {
          a_frag<WIDE>(pair(Qs + 8 * kk), pair(Qs + 8 * C::KS + 8 * kk), ah,
                       al);
        }
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const float2 x = pair(Ks + (8 * j + g) * C::KS + 8 * kk + 2 * t);
          mma_split<WIDE>(s[j], ah, al, x.x, x.y);
        }
      }

      // online softmax in base 2; masks only where the tile needs them
      const bool masked = k0 + BK > len || (causal && k0 + BK - 1 > w0);
      if (masked) {
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + 8 * j + 2 * t + (i & 1);
            const int row = w0 + g + 8 * (i >> 1);
            const bool ok = key < len && (!causal || key <= row);
            s[j][i] = ok ? s[j][i] * scale_log2 : NEG;
          }
      } else {
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[j][i] *= scale_log2;
      }
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) mt[i >> 1] = fmaxf(mt[i >> 1], s[j][i]);
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 1));
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 2));
        // 1 while the row has no valid key (m stays -1e30), else <= 1
        alpha[hh] = exp2f(m[hh] - mt[hh]);
        m[hh] = mt[hh];
        l[hh] *= alpha[hh];
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = exp2f(s[j][i] - m[i >> 1]);
      if (masked) {  // masked probabilities are exactly 0
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + 8 * j + 2 * t + (i & 1);
            const int row = w0 + g + 8 * (i >> 1);
            if (!(key < len && (!causal || key <= row))) s[j][i] = 0.f;
          }
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) l[i >> 1] += s[j][i];
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[j][i] *= alpha[i >> 1];

      // O += P V: P's A fragment of keys 8j.. is S's tile j as (c0, c2, c1,
      // c3); V's B fragment is rows 8j + 2t and 8j + 2t + 1
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t ph[4], pl[4];
        a_frag<true>(make_float2(s[j][0], s[j][1]),
                     make_float2(s[j][2], s[j][3]), ph, pl);
        const T* v0 = Vs + (8 * j + 2 * t) * C::VS + g;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          const float b0 = one(v0 + 8 * nd), b1 = one(v0 + C::VS + 8 * nd);
          if constexpr (WIDE) {
            mma_split<true>(o[nd], ph, pl, b0, b1);
          } else {  // V exact: P's two terms
            mma(o[nd], pl, __float_as_uint(b0), __float_as_uint(b1));
            mma(o[nd], ph, __float_as_uint(b0), __float_as_uint(b1));
          }
        }
      }
    }
    __syncthreads();  // stage n % STAGES is free for tile n + STAGES
  }

  // O / l (0 for a row without a valid key), pairs in T
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  T* ob = out + (size_t)(b * Hq + h) * Sq * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = w0 + g + 8 * hh;
    if (row >= Sq) continue;
    const float lr = l[hh];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const float x = lr > 0.f ? o[nd][2 * hh] / fmaxf(lr, 1e-30f) : 0.f;
      const float y = lr > 0.f ? o[nd][2 * hh + 1] / fmaxf(lr, 1e-30f) : 0.f;
      store_pair(ob + (size_t)row * D + 8 * nd + 2 * t, x, y);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, int B, int Hq, int Hkv,
                   int Sq, int Skv, int causal, float scale,
                   cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorMisalignedAddress;
  const int tiles = (Sq + BQ - 1) / BQ;
  if (tiles > 65535) return cudaErrorInvalidConfiguration;
  constexpr int smem = Cfg<T, D>::SMEM;
  auto kernel = flash_attn_fwd_tf32_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(Hq, B, tiles), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), Hq, Hkv, Sq, Skv, causal, scale * LOG2E);
  return cudaGetLastError();
}

// f32 at every head dim; bf16 at D 16/32 (D 64/128 belong to the
// tensor-core body), so each (type, head dim) has exactly one body.
cudaError_t dispatch(int D, int dtype, const void* q, const void* k,
                     const void* v, const void* kv_len, void* out, int B,
                     int Hq, int Hkv, int Sq, int Skv, int causal, float scale,
                     cudaStream_t s) {
#define B8_TF32(T, DD)                                                    \
  launch<T, DD>(q, k, v, kv_len, out, B, Hq, Hkv, Sq, Skv, causal, scale, \
                s)
  if (dtype == 0) switch (D) {
      case 16: return B8_TF32(float, 16);
      case 32: return B8_TF32(float, 32);
      case 64: return B8_TF32(float, 64);
      case 128: return B8_TF32(float, 128);
    }
  if (dtype == 1) switch (D) {
      case 16: return B8_TF32(__nv_bfloat16, 16);
      case 32: return B8_TF32(__nv_bfloat16, 32);
    }
#undef B8_TF32
  return cudaErrorInvalidValue;
}

}  // namespace tf32

// ---------------------------------------------------------------------------
// The tensor-core body (bf16, D in {64, 128})
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;          // query rows per block (two consumers x 64)
constexpr int PANEL = 64;        // bf16 columns of one 128-byte swizzled row
constexpr int ROW_BYTES = 128;   // bytes of one row of a panel
constexpr int THREADS = 384;     // producer + two consumer warpgroups
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  // keys per KV tile: 64 at D = 128 keeps S, P (hi + lo) and O in 240
  // registers a thread, so ptxas need not serialise the wgmmas
  static constexpr int BK = D == 64 ? 128 : 64;
  static constexpr int PANELS = D / PANEL;
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  // + slack to align the tiles to the 1024-byte swizzle atom
  static constexpr int SMEM = V_OFF + STAGES * KV_BYTES + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.  A
// wait past about 10 s (2^34 clocks) traps: a fault, never a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// One box of a 3-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of wgmma's registers across its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (m64n128, f32) = A·B (+ d if scale_d): A 64 x 16 and B 16 x 128, both
// from shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64n64, f32) = A·B (+ d if scale_d): A 64 x 16 and B 16 x 64, both
// from shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64n64, f32) += A·B: A 64 x 16 from registers (bf16 pairs), B
// 16 x 64 from shared memory, MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n128, f32) += A·B: A 64 x 16 from registers (bf16 pairs), B
// 16 x 128 from shared memory, MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S += Q·Kᵀ over one k-step (N = BK keys) and O += P·V (N = D columns).
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&s)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&s)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_ss_n64(s, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_qk<128>(float (&s)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  wgmma_ss_n128(s, da, db, scale_d);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Fragment coordinates (wgmma's f32 accumulator, m64nN): element i of a
// thread lies in row r0 + 8·((i >> 1) & 1) of its warpgroup's 64 and in
// column 8·(i / 4) + c0 + (i & 1), with r0 = 16·warp + lane / 4 and
// c0 = 2·(lane % 4).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attn_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const int* __restrict__ kv_len,
                             __nv_bfloat16* __restrict__ out, int Hq, int Hkv,
                             int Sq, int Skv, int causal, float scale_log2) {
  using C = Cfg<D>;
  constexpr int S = C::STAGES, BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  // barriers: Q full, K full x S, V full x S, K/V stage empty x S
  __shared__ __align__(8) uint64_t bars[1 + 3 * S];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + C::K_OFF, v_s = base + C::V_OFF;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_k = smem_u32(&bars[1]);          // + 8·stage
  const uint32_t bar_v = smem_u32(&bars[1 + S]);
  const uint32_t bar_e = smem_u32(&bars[1 + 2 * S]);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest rows first
  const int hk = h / (Hq / Hkv);                      // GQA
  const int len = min(kv_len[b], Skv);
  // Tiles from n_tiles on hold no valid key (all at or past kv_len, or, for
  // a causal mask, above every row of this block): skipping them is exact.
  const int k_end = causal ? min(len, q0 + BQ) : len;
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load of the block ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n_tiles > 0) {
      const int bh_q = b * Hq + h, bh_kv = b * Hkv + hk;
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int p = 0; p < C::PANELS; ++p)
        tma_load_3d(q_s + p * BQ * ROW_BYTES, &tm_q, bar_q, p * PANEL, q0,
                    bh_q);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % S;
        const uint32_t off = s * C::KV_BYTES;
        // the stage's previous tile is consumed (the first round passes)
        mbar_wait(bar_e + 8 * s, ((n / S) & 1) ^ 1);
        mbar_expect_tx(bar_k + 8 * s, C::KV_BYTES);
        for (int p = 0; p < C::PANELS; ++p)
          tma_load_3d(k_s + off + p * BK * ROW_BYTES, &tm_k, bar_k + 8 * s,
                      p * PANEL, n * BK, bh_kv);
        mbar_expect_tx(bar_v + 8 * s, C::KV_BYTES);
        for (int p = 0; p < C::PANELS; ++p)
          tma_load_3d(v_s + off + p * BK * ROW_BYTES, &tm_v, bar_v + 8 * s,
                      p * PANEL, n * BK, bh_kv);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = 16 * (t / 32) + lane / 4, c0 = 2 * (lane % 4);
    const int row0 = q0 + 64 * c + r0;  // query index of fragment row 0

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this thread's part

    if (n_tiles > 0) mbar_wait(bar_q, 0);
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % S;
      const uint32_t ph = (n / S) & 1, off = s * C::KV_BYTES;
      const int k0 = n * BK;

      // S = Q Kᵀ (64 x BK, f32)
      float sc[BK / 2];
      mbar_wait(bar_k + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // 16 bf16 within the panel
        const uint64_t da = desc_sw128(
            q_s + (kk / 4) * BQ * ROW_BYTES + c * 64 * ROW_BYTES + col, 16,
            1024);
        const uint64_t db = desc_sw128(
            k_s + off + (kk / 4) * BK * ROW_BYTES + col, 16, 1024);
        wgmma_qk<BK>(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // online softmax in base 2; masks only where the tile needs them
      const bool masked =
          k0 + BK > len || (causal && k0 + BK - 1 > q0 + 64 * c);
      if (masked) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + c0 + (i & 1);
          const int row = row0 + 8 * ((i >> 1) & 1);
          const bool ok = key < len && (!causal || key <= row);
          sc[i] = ok ? sc[i] * scale_log2 : NEG;
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
      }
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sc[i]);
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 1));
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 2));
        // 1 while the row has no valid key (m stays -1e30), else <= 1
        alpha[hh] = exp2f(m[hh] - mt[hh]);
        m[hh] = mt[hh];
        l[hh] *= alpha[hh];
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);
      if (masked) {  // masked probabilities are exactly 0
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + c0 + (i & 1);
          const int row = row0 + 8 * ((i >> 1) & 1);
          if (!(key < len && (!causal || key <= row))) sc[i] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) l[(i >> 1) & 1] += sc[i];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // P as bf16 hi + lo A fragments: k-step kk takes S elements 8kk..8kk+7
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = sc[8 * kk + 2 * r], y = sc[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[kk][r] = bf16x2_bits(hi);
          p_lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
        }

      // O += P V: V rows are keys (K), D columns (N) contiguous: MN-major
      mbar_wait(bar_v + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db =
            desc_sw128(v_s + off + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024);
        wgmma_pv<D>(o, p_hi[kk], db);
        wgmma_pv<D>(o, p_lo[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      if (t == 0) mbar_arrive(bar_e + 8 * s);  // this consumer is done here
    }

    // O / l (0 for a row without a valid key), bf16 pairs
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
    __nv_bfloat16* ob = out + (size_t)(b * Hq + h) * Sq * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= Sq) continue;
      const float lr = l[hh];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int i = 4 * j + 2 * hh;
        const float x = lr > 0.f ? o[i] / fmaxf(lr, 1e-30f) : 0.f;
        const float y = lr > 0.f ? o[i + 1] / fmaxf(lr, 1e-30f) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + 8 * j +
                                           c0) = __floats2bfloat162_rn(x, y);
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (D, S, BH) bf16 map read in boxes of 64 columns x `rows` rows, with the
// 128-byte swizzle; rows past S read as zeros.
bool make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int D,
              int S, int BH, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)PANEL, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, int B, int Hq, int Hkv,
                   int Sq, int Skv, int causal, float scale,
                   cudaStream_t stream) {
  const EncodeTiledFn encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return cudaErrorMisalignedAddress;
  if ((Sq + BQ - 1) / BQ > 65535) return cudaErrorInvalidConfiguration;
  CUtensorMap mq, mk, mv;
  // without keys no tile is loaded: K/V's maps then describe q's memory
  const bool no_keys = Skv == 0;
  if (!make_map(encode, &mq, q, D, Sq, B * Hq, BQ) ||
      !make_map(encode, &mk, no_keys ? q : k, D, no_keys ? Sq : Skv,
                no_keys ? B * Hq : B * Hkv, Cfg<D>::BK) ||
      !make_map(encode, &mv, no_keys ? q : v, D, no_keys ? Sq : Skv,
                no_keys ? B * Hq : B * Hkv, Cfg<D>::BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_attn_fwd_tc_kernel<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, Cfg<D>::SMEM, stream>>>(
      mq, mk, mv, static_cast<const int*>(kv_len),
      static_cast<__nv_bfloat16*>(out), Hq, Hkv, Sq, Skv, causal,
      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace tc


// 1 if flash_attn_fwd runs the tensor-core body for this head dim and type
// (dtype: 0 = f32, 1 = bf16), else 0: the wrapper counts each body apart.
extern "C" int flash_attn_fwd_tensor_cores(int D, int dtype) {
  return dtype == 1 && (D == 64 || D == 128) ? 1 : 0;
}

// Plain C entry point (loaded with ctypes).  dtype: 0 = f32, 1 = bf16.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* kv_len, void* out, int B, int Hq,
                              int Hkv, int Sq, int Skv, int D, int causal,
                              int dtype, float scale, void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flash_attn_fwd_tensor_cores(D, dtype))
    return (int)(D == 64 ? tc::launch<64>(q, k, v, kv_len, out, B, Hq, Hkv,
                                          Sq, Skv, causal, scale, s)
                         : tc::launch<128>(q, k, v, kv_len, out, B, Hq, Hkv,
                                           Sq, Skv, causal, scale, s));
  return (int)tf32::dispatch(D, dtype, q, k, v, kv_len, out, B, Hq, Hkv, Sq,
                             Skv, causal, scale, s);
}
