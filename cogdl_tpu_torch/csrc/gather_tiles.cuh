// The schedule K4 (gather_block.cu) and K5 (gather_window.cu) share: work
// by window and column tile, not by chunk.
//
// Both probes compute, for chunk c of `chunk` slots and its window
// v(c) = c % n_windows of `span` rows (K5: span = W; K4: span = chunk),
//
//   out[c] = sum_{s < chunk} sum_{f < 128} table[v(c)*span + idx[c*chunk + s], f]
//
// A thread block owns one (window v, column tile j) pair: `tc` of the 128
// columns of the window's `span` rows. It serves every chunk c = v,
// v + n_windows, v + 2 n_windows, ... in increasing c, so the window's tile
// comes onto the SM once for all of them (K5 stages it in shared memory, K4
// lets L1 hold it). Blocks are numbered window-major, (v, j) -> v * n_tiles
// + j, so the blocks that run together read whole 512-byte rows between
// them. Only windows that serve a chunk get blocks.
//
// Inside a block, each chunk is cut into `segments` runs of slots and each
// warp takes whole (chunk, segment) items, item w, w + warps, ...; the warp
// sums its item's rows over the tile's columns and writes that one float.
// So a chunk's sum is n_tiles * segments partial floats, each written by
// one warp; `gather_add_partials` adds them per chunk in (tile, segment)
// order. With one partial a chunk the warp writes `out` itself and the
// second kernel is not started. One writer per float and fixed orders: a
// call gives the same bits every time, and no atomics are used.
//
// A warp reads a run of slots 32 at a time: each lane loads one index
// (clamped into [0, span); the loads of the next 128 are in flight while
// the current 128 rows are summed, and bypass L1 so that they do not evict
// the tile), then the warp reads rows of tc floats, tc / 4 lanes a row,
// each lane a float4, the row number passed by shuffle. With tc >= 32 a row's
// part is 128 bytes or more: a quarter-warp's 8 float4 cover the 32 banks
// once, so the reads of random rows need the fewest wavefronts.
//
// No algebraic shortcut: every slot's tc floats of each tile pass through
// the probe's mechanism (no row sums, counts or histograms precomputed, no
// result kept across calls), because the probes measure what a row gather
// costs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Everything here is in the includer's anonymous namespace: each source
// gets its own copy, so the library links without duplicate symbols.
namespace {

constexpr int kRowVec4 = 32;  // a 128-float row as float4
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  return v;
}

// one index, clamped into [0, hi), read without allocating in L1
__device__ __forceinline__ int load_index(const int* p, int hi) {
  int v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];"
      : "=r"(v)
      : "l"(__cvta_generic_to_global(p)));
  return min(max(v, 0), hi - 1);
}

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

// What one block serves: its window, its tile, its chunks and items.
struct Work {
  int v, j, n_tiles;  // window (and its first chunk), column tile, tiles a row
  int n_items;        // its chunks times `segments`
};

__device__ __forceinline__ Work block_work(int n_chunks, int n_windows,
                                           int n_tiles, int segments) {
  Work w;
  w.v = blockIdx.x / n_tiles;
  w.j = blockIdx.x - w.v * n_tiles;
  w.n_tiles = n_tiles;
  const int m = (n_chunks - 1 - w.v) / n_windows + 1;  // chunks of window v
  w.n_items = m * segments;
  return w;
}

// Index batches a warp loads ahead: the indices of the next 4 x 32 slots
// are in flight while the current 4 x 32 rows are read.
constexpr int kIndexBatches = 4;

// The rows of one batch of 32 slots whose indices `cur` holds, lane i the
// index of slot i; n slots of it are real.
template <int Q4, class Fetch>
__device__ __forceinline__ void batch_sum(float4& acc, int cur, int n,
                                          const Fetch& fetch, int g, int q) {
  constexpr int R = 32 / Q4;  // rows a warp reads a step
  if (n >= 32) {
#pragma unroll
    for (int t = 0; t < Q4; ++t)
      add4(acc, fetch(__shfl_sync(kFullMask, cur, t * R + g), q));
  } else {
#pragma unroll
    for (int t = 0; t < Q4; ++t) {
      const int s = t * R + g;
      const int r = __shfl_sync(kFullMask, cur, s);
      if (s < n) add4(acc, fetch(r, q));
    }
  }
}

// The sum of tile columns over the rows that ids[0, len) name, as each
// lane's float4; Q4 = tc / 4 lanes a row. fetch(r, q) returns float4 q of
// row r's tile part. Fetch::kWholeGroups: read a group of D whole batches
// as one unrolled run (K5's shared-memory reads: more of them in flight) or
// batch by batch (K4's L1 loads, which measured faster so on the H100).
template <int Q4, class Fetch>
__device__ __forceinline__ float4 segment_sum(const int* __restrict__ ids,
                                              int len, int hi,
                                              const Fetch& fetch, int lane) {
  constexpr int D = kIndexBatches;
  const int g = lane / Q4;
  const int q = lane - g * Q4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int cur[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int p = d * 32 + lane;
    cur[d] = p < len ? load_index(ids + p, hi) : 0;
  }
  constexpr int R = 32 / Q4;
  for (int b = 0; b < len; b += 32 * D) {
    int nxt[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int p = b + (D + d) * 32 + lane;
      nxt[d] = p < len ? load_index(ids + p, hi) : 0;
    }
    if (Fetch::kWholeGroups && len - b >= 32 * D) {
      // all D batches whole: one straight run of D * Q4 independent reads
#pragma unroll
      for (int d = 0; d < D; ++d)
#pragma unroll
        for (int t = 0; t < Q4; ++t)
          add4(acc, fetch(__shfl_sync(kFullMask, cur[d], t * R + g), q));
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int n = len - b - d * 32;
        if (n > 0) batch_sum<Q4>(acc, cur[d], n, fetch, g, q);
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) cur[d] = nxt[d];
  }
  return acc;
}

// Every item of the block `work`, warp by warp; partial (c, j, s) goes to
// dst[c * n_tiles * segments + j * segments + s].
template <int Q4, class Fetch>
__device__ __forceinline__ void serve_items(const Work& work,
                                            const int* __restrict__ idx,
                                            float* __restrict__ dst,
                                            int n_windows, int chunk,
                                            int span, int segments,
                                            const Fetch& fetch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int seg_len = (chunk + segments - 1) / segments;
  for (int it = warp; it < work.n_items; it += warps) {
    const int k = it / segments;
    const int s = it - k * segments;
    const int c = work.v + k * n_windows;
    const int lo = s * seg_len;
    const int len = min(seg_len, chunk - lo);
    const float4 a = segment_sum<Q4>(idx + (size_t)c * chunk + lo, len, span,
                                     fetch, lane);
    const float part = warp_sum((a.x + a.y) + (a.z + a.w));
    if (lane == 0)
      dst[((size_t)c * work.n_tiles + work.j) * segments + s] = part;
  }
}

// out[c] = the `per_chunk` partials of chunk c added in order. It is a
// programmatic dependent launch (finish): it waits for the writes of the
// kernel before it on the stream first, then lets the next kernel launch.
__global__ void gather_add_partials(const float* __restrict__ part,
                                    float* __restrict__ out, int n_chunks,
                                    int per_chunk) {
  constexpr int kBatch = 16;  // loads in flight before their adds
  asm volatile("griddepcontrol.wait;\n"
               "griddepcontrol.launch_dependents;\n" ::: "memory");
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chunks) return;
  const float* p = part + (size_t)c * per_chunk;
  // p[0] + p[1] + ... left to right, the loads of a batch issued together
  float t = 0.f;
  for (int b = 0; b < per_chunk; b += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      v[k] = b + k < per_chunk ? p[b + k] : 0.f;
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (b + k < per_chunk) t = b + k == 0 ? v[k] : t + v[k];
  }
  out[c] = t;
}

// The launch attribute of a programmatic dependent launch (Hopper): the
// kernel may start while the one before it on the stream ends, once that
// one lets it (griddepcontrol.launch_dependents, or its end); it waits for
// that kernel's writes with griddepcontrol.wait before it reads anything.
inline cudaLaunchAttribute* overlap_attr() {
  static cudaLaunchAttribute attr = [] {
    cudaLaunchAttribute a = {};
    a.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    a.val.programmaticStreamSerializationAllowed = 1;
    return a;
  }();
  return &attr;
}

// Starts gather_add_partials when a chunk has more than one partial, as a
// programmatic dependent of the kernel that wrote them; counts the CUDA
// kernels started in *started.
inline cudaError_t finish(const float* part, float* out, int n_chunks,
                          int per_chunk, int* started, cudaStream_t stream) {
  if (per_chunk == 1) return cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_chunks + 255) / 256);
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cfg.attrs = overlap_attr();
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gather_add_partials, part,
                                             out, n_chunks, per_chunk);
  if (err != cudaSuccess) return err;
  ++*started;
  return cudaGetLastError();
}

// The checks both entry points make before a launch.
inline bool bad_args(const float* table, int n_rows, int n_chunks, int chunk,
                     int span, int tile_cols, int segments, int max_chunk) {
  return span <= 0 || n_rows < span || chunk <= 0 || chunk > max_chunk ||
         n_chunks < 0 || tile_cols < 8 || tile_cols > 128 ||
         (tile_cols & (tile_cols - 1)) || segments < 1 || segments > chunk ||
         (reinterpret_cast<uintptr_t>(table) & 15u);
}

}  // namespace
