// K4 for Hopper: per-chunk sum of table rows gathered inside the chunk's own
// block of the table, by plain indexed loads that L1 serves once the
// block's columns have come onto the SM.
//
//   part[c] = sum_{s < T} sum_{f < 128} table[b(c)*T + idx[c*T + s], f]
//   b(c)    = c % (n_rows / T)
//
// Replaces the Pallas TPU probe `make_dyn_gather`
// (scripts/microbench_gather7.py:73, call :82). There each chunk of T = 1024
// slots gathers from its own [T, 128] operand block with
// `take_along_axis`, which Mosaic lowers to the hardware sublane gather
// (operand shape == output shape, indices local to the block). The function
// is "sum of the rows of block b(c) that idx names"; the mechanism this card
// has for it is the indexed load through the hardware-managed caches, and
// K4 stays that probe: it stages nothing in shared memory (K5 does).
//
// Block index: the Pallas BlockSpec takes block c of the table for chunk c
// and so leaves the table for c >= n_rows / T (at the script's sizes c runs
// to 3071 over 98 blocks); what the TPU read there is not defined by the
// source. This kernel takes block c % (n_rows / T), which is the Pallas
// kernel wherever that one is in range and is how the one-hot probe (K5)
// wraps its windows.
//
// What bounds it on an H100: the chip's on-chip memory. Every slot's 512
// bytes must come through L1, 128 bytes a clock on each of 132 SMs (33.4
// TB/s at 1.98 GHz, about 0.048 ms a call at the probe's sizes). The guide's
// bytes bound (the table and indices read once from device memory, 0.019
// ms) stays the bound of record. No tensor cores: the function has one add
// a float and no product. No algebraic shortcut (gather_tiles.cuh).
//
// Design (the schedule in gather_tiles.cuh, tiles of 32 columns):
//   * a thread block owns block b of the table and one of its four column
//     quarters (T rows x 128 bytes: 128 KB at T = 1024, one 128-byte L1
//     line a row) and serves every chunk c = b (mod n_blocks) in turn. It
//     first touches each line of its quarter once (prefetch.global.L1), so
//     the quarter is read from L2 once and the chunks' loads then hit in L1;
//     the chunks that share a block no longer scatter over the grid;
//   * 32 warps a block, so that one block fills an SM's threads and no
//     second quarter competes for its L1; each warp sums whole (chunk,
//     segment) items, 8 lanes a row as float4, the indices loaded past L1;
//   * the shared-memory carve-out is set to its least (L1 its largest; the
//     sweep also times the CUDA driver's default) and the rows are read with
//     ld.global.nc (ld.global.ca measured no faster);
//   * a chunk's four quarter partials are added in order by a second small
//     kernel; no atomics.
// Indices outside [0, T) are clamped into it, so no load leaves the block.

#include "gather_tiles.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kQ4 = 8;        // a 32-float quarter as float4
constexpr int kTiles = kRowVec4 / kQ4;

struct BlockRows {
  static constexpr bool kWholeGroups = false;
  const float4* base;  // float4 j * kQ4 of the block's first row
  __device__ __forceinline__ float4 operator()(int r, int q) const {
    const size_t p = __cvta_generic_to_global(base + (size_t)r * kRowVec4 + q);
    float4 v;
    asm("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p));
    return v;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
gather_block_quarters_kernel(const float4* __restrict__ table,
                             const int* __restrict__ idx,
                             float* __restrict__ dst, int n_chunks,
                             int n_blocks, int chunk, int segments) {
  const Work work = block_work(n_chunks, n_blocks, kTiles, segments);
  const float4* base =
      table + (size_t)work.v * chunk * kRowVec4 + work.j * kQ4;
  for (int r = threadIdx.x; r < chunk; r += kThreads)
    asm volatile("prefetch.global.L1 [%0];"
                 :
                 : "l"(__cvta_generic_to_global(base + (size_t)r * kRowVec4)));
  serve_items<kQ4>(work, idx, dst, n_blocks, chunk, chunk, segments,
                   BlockRows{base});
}

}  // namespace

// Launches K4 on `stream` (a cudaStream_t). table is [n_rows, 128] fp32
// row-major and 16-byte aligned, idx has n_chunks * chunk int32 entries
// (clamped into [0, chunk)), out n_chunks floats, partial n_chunks * 4 *
// segments floats; segments in [1, chunk] (gather_tiles.cuh); n_rows >=
// chunk. max_l1: 1 sets the shared-memory carve-out to its least, 0 leaves
// it to the CUDA driver. *started gets the number of CUDA kernels started.
// Returns a cudaError_t (0 on success).
extern "C" int gather_block_sum_f32(const float* table, const int* idx,
                                    float* out, float* partial, int n_rows,
                                    int n_chunks, int chunk, int segments,
                                    int max_l1, int* started, void* stream) {
  *started = 0;
  if (n_chunks == 0) return 0;
  if (bad_args(table, n_rows, n_chunks, chunk, chunk, 32, segments,
               1 << 30) ||
      partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      gather_block_quarters_kernel,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      max_l1 ? static_cast<int>(cudaSharedmemCarveoutMaxL1)
             : static_cast<int>(cudaSharedmemCarveoutDefault));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = n_rows / chunk;
  const int used = n_blocks < n_chunks ? n_blocks : n_chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather_block_quarters_kernel<<<used * kTiles, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(table), idx, partial, n_chunks,
      n_blocks, chunk, segments);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *started = 1;
  return static_cast<int>(
      finish(partial, out, n_chunks, kTiles * segments, started, s));
}

// Blocks of K4 that share one SM (-1 on error): the gather sweep records it.
extern "C" int gather_block_blocks_per_sm() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, gather_block_quarters_kernel, kThreads, 0);
  return err == cudaSuccess ? n : -1;
}

extern "C" const char* gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
