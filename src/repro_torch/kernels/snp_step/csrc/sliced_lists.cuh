// The sliced in-lists and the neuron-major stage, shared by the two
// sources whose kernels walk them: snp_step_sparse.cu (B2, B3, B5, B7)
// and snp_step_dense_delay.cu (B4).  This header owns what the two have
// in common, so one rule holds for both:
//
//   * the block shape: BT rows a block (the largest power of two <= 8
//     and <= T whose stage fits the 227 KB opt-in) and the threads (1024
//     once each of the 32 warps has a slice of 32 neurons of its own, m >=
//     1,024, else 256);
//   * the stage: BT rows of one value a source, neuron-major
//     (stage[src*BT + r]), so a source's rows come back in one 16-byte
//     shared load (uint16 values, the sparse source) or two (int32, B4);
//   * the walk: a warp takes slices warp, warp + NW, ... of 32 neurons;
//     lane i loads the bounds of the i-th of the next 32 slices at once;
//     entry k of neuron 32s + l sits at sell_start[s] + 32k + l
//     (core/matrix.py::sliced_in_lists), so the lanes' loads coalesce;
//     four entries go out at a time, a vector gather each, BT adds
//     (SliceBounds, gather);
//   * forged lists: an entry outside [0, z] reads the zero slot z, and
//     slice bounds are clamped to the lists' length, so no list reads out
//     of bounds (one compare an entry, no host read).
//
// The C entries also take an explicit shape (bt rows, nt threads; 0 keeps
// the rule), which the planner's autotuner times (core/autotune.py) and
// probes/sell_block_threads.py sweeps; valid_rows and valid_threads say
// which shapes have an instance.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace sell {

constexpr int BT_MAX = 8;                     // branch rows per block
constexpr int SMEM_LIMIT = 232448;            // opt-in max per block (227 KB)
constexpr unsigned FULL = 0xffffffffu;

// Rows a block: the largest power of two <= BT_MAX (and <= T) whose stage
// of w + 1 values of `bytes` bytes a row fits the opt-in limit.
inline int rows_per_block(int w, int T, int bytes) {
  int bt = BT_MAX;
  while (bt > 1 && (bt > T || (size_t)bt * (w + 1) * bytes > SMEM_LIMIT))
    bt >>= 1;
  return bt;
}

// Threads a block for m (local) neurons.
inline int threads(int m) { return m >= 32 * 32 ? 1024 : 256; }

// The shapes a kernel of these sources has an instance for.
inline bool valid_rows(int bt) {
  return bt == 1 || bt == 2 || bt == 4 || bt == 8;
}
inline bool valid_threads(int nt) { return nt == 256 || nt == 1024; }

// Opt in to `smem` bytes of dynamic shared memory where it passes 48 KB.
template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// A list entry outside [0, z] reads the zero slot z.
__device__ __forceinline__ int in_range(int src, int z) {
  return (unsigned)src > (unsigned)z ? z : src;
}

// Source j's BT staged values, each below 2^16, in one vector store.
template <int BT>
__device__ __forceinline__ void put_rows(unsigned short* stage, int j,
                                         const unsigned (&v)[BT]) {
  if constexpr (BT == 1) {
    stage[j] = (unsigned short)v[0];
  } else {
    unsigned w[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i)
      w[i] = (v[2 * i] & 0xFFFFu) | (v[2 * i + 1] << 16);
    if constexpr (BT == 8)
      reinterpret_cast<uint4*>(stage)[j] = make_uint4(w[0], w[1], w[2], w[3]);
    else if constexpr (BT == 4)
      reinterpret_cast<uint2*>(stage)[j] = make_uint2(w[0], w[1]);
    else
      reinterpret_cast<unsigned*>(stage)[j] = w[0];
  }
}

// Source j's BT staged int32 values in one or two vector stores.
template <int BT>
__device__ __forceinline__ void put_rows(unsigned* stage, int j,
                                         const unsigned (&v)[BT]) {
  if constexpr (BT == 8) {
    uint4* q = reinterpret_cast<uint4*>(stage) + 2 * (size_t)j;
    q[0] = make_uint4(v[0], v[1], v[2], v[3]);
    q[1] = make_uint4(v[4], v[5], v[6], v[7]);
  } else if constexpr (BT == 4) {
    reinterpret_cast<uint4*>(stage)[j] = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (BT == 2) {
    reinterpret_cast<uint2*>(stage)[j] = make_uint2(v[0], v[1]);
  } else {
    stage[j] = v[0];
  }
}

// acc[r] += source src's uint16 value in row r, for the BT rows (one
// vector load).
template <int BT>
__device__ __forceinline__ void add_rows(const unsigned short* stage,
                                         int src, unsigned (&acc)[BT]) {
  if constexpr (BT == 1) {
    acc[0] += stage[src];
  } else {
    unsigned w[BT / 2];
    if constexpr (BT == 8) {
      const uint4 q = reinterpret_cast<const uint4*>(stage)[src];
      w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
    } else if constexpr (BT == 4) {
      const uint2 q = reinterpret_cast<const uint2*>(stage)[src];
      w[0] = q.x, w[1] = q.y;
    } else {
      w[0] = reinterpret_cast<const unsigned*>(stage)[src];
    }
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      acc[2 * i] += w[i] & 0xFFFFu;
      acc[2 * i + 1] += w[i] >> 16;
    }
  }
}

// acc[r] += source src's int32 value in row r, for the BT rows.
template <int BT>
__device__ __forceinline__ void add_rows(const unsigned* stage, int src,
                                         unsigned (&acc)[BT]) {
  if constexpr (BT == 8) {
    const uint4* q = reinterpret_cast<const uint4*>(stage) + 2 * (size_t)src;
    const uint4 x = q[0], y = q[1];
    acc[0] += x.x, acc[1] += x.y, acc[2] += x.z, acc[3] += x.w;
    acc[4] += y.x, acc[5] += y.y, acc[6] += y.z, acc[7] += y.w;
  } else if constexpr (BT == 4) {
    const uint4 x = reinterpret_cast<const uint4*>(stage)[src];
    acc[0] += x.x, acc[1] += x.y, acc[2] += x.z, acc[3] += x.w;
  } else if constexpr (BT == 2) {
    const uint2 x = reinterpret_cast<const uint2*>(stage)[src];
    acc[0] += x.x, acc[1] += x.y;
  } else {
    acc[0] += stage[src];
  }
}

// acc[r] = the sum over a slice's w entries src[0], src[32], ... (the
// lane's list; zero slot z) of the staged values in row r: four entries'
// loads in flight, then their gathers.
template <int BT, typename Stage>
__device__ __forceinline__ void gather(const Stage* stage, const int* src,
                                       int w, int z, unsigned (&acc)[BT]) {
#pragma unroll
  for (int r = 0; r < BT; ++r) acc[r] = 0;
  int k = 0;
  for (; k + 4 <= w; k += 4) {
    int x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = src[(k + u) * 32];
#pragma unroll
    for (int u = 0; u < 4; ++u) add_rows<BT>(stage, in_range(x[u], z), acc);
  }
  for (; k < w; ++k) add_rows<BT>(stage, in_range(src[k * 32], z), acc);
}

// The bounds of a warp's next 32 slices, g, g + nw, ..., g + 31*nw (those
// below n_slices), over lists of E entries: lane i holds slice g + i*nw's
// start and end, clamped to [0, E], loaded at once.  A kernel walks them
// with its own loops (a lambda taking the loop body cost B4 a 12-byte
// spill at 8 rows):
//   for (int g = warp; g < n_slices; g += NW * 32) {    // warp-uniform
//     const SliceBounds sb(sell_start, g, NW, n_slices, E, lane);
//     for (int i = 0; i < sb.n; ++i) {
//       int w;                                           // slice width
//       const int* src = sb.entries(i, sell_src, lane, w);
//       const int j = sb.neuron(i, g, NW, lane);         // may be >= m
//       ...
struct SliceBounds {
  int a = 0, e = 0, n;

  __device__ __forceinline__ SliceBounds(const int* sell_start, int g,
                                         int nw, int n_slices, int E,
                                         int lane) {
    if (g + lane * nw < n_slices) {
      a = min(max(sell_start[g + lane * nw], 0), E);
      e = min(max(sell_start[g + lane * nw + 1], a), E);
    }
    n = min(32, (n_slices - g + nw - 1) / nw);
  }

  // Slice i's width (entries a neuron) and the lane's first entry.
  __device__ __forceinline__ const int* entries(int i, const int* sell_src,
                                                int lane, int& w) const {
    const int start = __shfl_sync(FULL, a, i);
    w = (__shfl_sync(FULL, e, i) - start) >> 5;
    return sell_src + start + lane;
  }

  // The lane's neuron in slice i.
  __device__ __forceinline__ static int neuron(int i, int g, int nw,
                                               int lane) {
    return ((g + i * nw) << 5) + lane;
  }
};

}  // namespace sell
