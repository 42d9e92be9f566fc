// K5 for Hopper: per-chunk sum of table rows gathered from a window of the
// table that is staged in shared memory once for all the chunks that read
// it.
//
//   part[c] = sum_{s < T} sum_{f < 128} table[v(c)*W + idx[c*T + s], f]
//   v(c)    = c % (n_rows / W),  W = window
//
// Replaces the Pallas TPU probe `make_onehot`
// (scripts/microbench_gather7.py:100, call :111). There the rows are picked
// by a one-hot [T, W] x [W, 128] product on the matrix unit, which is how a
// TPU selects rows from a VMEM-resident window. Here the window is staged
// in shared memory and the rows are read out of it by index.
//
// No tensor cores: on this card the one-hot product does W times the
// gather's work (2 * T * W * 128 flops a chunk, 825 GFLOP a call at
// W = 1024, over 1.7 ms at the 495 TFLOP/s TF32 rate), and TF32 rounding
// of the table would break the 1e-6 + 1e-5 * sum|terms| limit (3xTF32
// triples the work). No algebraic shortcut either (gather_tiles.cuh):
// every slot's 128 floats are read from the staged window.
//
// What bounds it on an H100: the chip's on-chip memory. Every slot's 512
// bytes must be read out of shared memory, 128 bytes a clock on each of 132
// SMs (33.4 TB/s at 1.98 GHz): 1.61 GB a call at the probe's sizes, about
// 0.048 ms. The guide's bytes bound (the table and indices read once from
// device memory, 0.019 ms) stays the bound of record.
//
// Design (the schedule in gather_tiles.cuh):
//   * a thread block owns a window and a column tile of tc columns and
//     serves every chunk of that window; the tile (W rows x tc floats) is
//     staged with cp.async once, so a call stages the used part of the
//     table once (51 MB at the probe's sizes, not 1.61 GB as when every
//     chunk staged its own window);
//   * tc = 32 columns (4 tiles), the tile W x 128 B, while that fits a
//     block's 227 KB (W <= 1816; at W = 1024 128 KB and one block a SM,
//     at 256 and 512 two blocks a SM), else the widest power of two that
//     fits (W = 2048: 16, 4096: 8), where two rows of a quarter-warp share
//     banks half the time (1.5 wavefronts a phase); recorded, not tuned.
//     Tried (the gather sweep of chip_smoke.py times every width): wider
//     tiles (64, 128 columns) and narrower ones with more blocks a SM were
//     slower at every probe window;
//   * 16 warps a block, each summing whole (chunk, segment) items out of
//     the tile, lanes across the tile's columns as float4, the row number by
//     shuffle from the lane that loaded the index;
//   * the partials of a chunk's tiles and segments are added in order by
//     a second small kernel (none when a chunk has one partial).
//   Not built: a cluster of a window's tiles adding its partials through
//   distributed shared memory, with one multicast load of the indices; the
//   partials are at most 96 KB a call at the probe's sizes (3072 chunks x
//   8) and the kernel that adds them is short.
// Indices outside [0, W) are clamped into it, so no read leaves the tile.

#include "gather_tiles.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxChunk = 4096;
constexpr int kMaxTileBytes = 232448;  // the shared memory a block may have

__device__ __forceinline__ void cp_async_16(void* smem_dst,
                                            const void* global_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const size_t src = __cvta_generic_to_global(global_src);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(dst), "l"(src)
               : "memory");
}

template <int Q4>
struct TileRows {
  static constexpr bool kWholeGroups = true;
  unsigned tile;  // shared-memory address of the tile
  __device__ __forceinline__ float4 operator()(int r, int q) const {
    float4 v;
    // volatile: not moved above the __syncthreads that ends the staging
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(tile + static_cast<unsigned>(r * Q4 + q) * 16u));
    return v;
  }
};

// Q4 = tc / 4: float4 a window row in a tile. Dynamic shared memory: the
// tile, window * Q4 float4.
template <int Q4>
__global__ void __launch_bounds__(kThreads)
gather_window_tiles_kernel(const float4* __restrict__ table,
                           const int* __restrict__ idx,
                           float* __restrict__ dst, int n_chunks,
                           int n_windows, int window, int chunk,
                           int segments) {
  extern __shared__ float4 tile[];
  const Work work = block_work(n_chunks, n_windows, kRowVec4 / Q4, segments);
  const float4* src =
      table + (size_t)work.v * window * kRowVec4 + work.j * Q4;
  for (int i = threadIdx.x; i < window * Q4; i += kThreads) {
    const int r = i / Q4;
    cp_async_16(tile + i, src + (size_t)r * kRowVec4 + (i - r * Q4));
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  serve_items<Q4>(work, idx, dst, n_windows, chunk, window, segments,
                  TileRows<Q4>{static_cast<unsigned>(
                      __cvta_generic_to_shared(tile))});
}

template <int Q4>
cudaError_t launch(const float* table, const int* idx, float* dst,
                   int n_chunks, int n_windows, int window, int chunk,
                   int segments, cudaStream_t stream) {
  const int smem = window * Q4 * static_cast<int>(sizeof(float4));
  cudaError_t err = cudaFuncSetAttribute(
      gather_window_tiles_kernel<Q4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int used = n_windows < n_chunks ? n_windows : n_chunks;
  gather_window_tiles_kernel<Q4><<<used * (kRowVec4 / Q4), kThreads, smem,
                                   stream>>>(
      reinterpret_cast<const float4*>(table), idx, dst, n_chunks, n_windows,
      window, chunk, segments);
  return cudaGetLastError();
}

template <int Q4>
int blocks_per_sm(int window) {
  int n = 0;
  const int smem = window * Q4 * static_cast<int>(sizeof(float4));
  if (cudaFuncSetAttribute(gather_window_tiles_kernel<Q4>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, gather_window_tiles_kernel<Q4>, kThreads, smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// Launches K5 on `stream` (a cudaStream_t). table is [n_rows, 128] fp32
// row-major and 16-byte aligned, idx has n_chunks * chunk int32 entries
// (clamped into [0, window)), out n_chunks floats. tile_cols, a power of two
// in [8, 128] with window * tile_cols * 4 bytes <= 227 KB, and segments, in
// [1, chunk], cut the work (gather_tiles.cuh); partial holds n_chunks *
// (128 / tile_cols) * segments floats unless that is 1 per chunk (then it
// may be null). chunk <= 4096, n_rows >= window. *started gets the number
// of CUDA kernels started. Returns a cudaError_t (0 on success).
extern "C" int gather_window_sum_f32(const float* table, const int* idx,
                                     float* out, float* partial, int n_rows,
                                     int n_chunks, int chunk, int window,
                                     int tile_cols, int segments,
                                     int* started, void* stream) {
  *started = 0;
  if (n_chunks == 0) return 0;
  if (bad_args(table, n_rows, n_chunks, chunk, window, tile_cols, segments,
               kMaxChunk) ||
      (long long)window * tile_cols * 4 > kMaxTileBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_chunk = (128 / tile_cols) * segments;
  if (per_chunk > 1 && partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  float* dst = per_chunk == 1 ? out : partial;
  const int n_windows = n_rows / window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile_cols) {
    case 8: err = launch<2>(table, idx, dst, n_chunks, n_windows, window, chunk, segments, s); break;
    case 16: err = launch<4>(table, idx, dst, n_chunks, n_windows, window, chunk, segments, s); break;
    case 32: err = launch<8>(table, idx, dst, n_chunks, n_windows, window, chunk, segments, s); break;
    case 64: err = launch<16>(table, idx, dst, n_chunks, n_windows, window, chunk, segments, s); break;
    default: err = launch<32>(table, idx, dst, n_chunks, n_windows, window, chunk, segments, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *started = 1;
  return static_cast<int>(finish(partial, out, n_chunks, per_chunk, started, s));
}

// Blocks of K5 that share one SM at this window and tile width (-1 on
// error): what the gather sweep records beside each time.
extern "C" int gather_window_blocks_per_sm(int window, int tile_cols) {
  switch (tile_cols) {
    case 8: return blocks_per_sm<2>(window);
    case 16: return blocks_per_sm<4>(window);
    case 32: return blocks_per_sm<8>(window);
    case 64: return blocks_per_sm<16>(window);
    case 128: return blocks_per_sm<32>(window);
    default: return -1;
  }
}
