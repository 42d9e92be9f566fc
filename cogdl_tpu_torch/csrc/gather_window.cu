// K5 for Hopper: per-chunk sum of table rows gathered from a window of the
// table that is staged in shared memory.
//
//   part[c] = sum_{s < T} sum_{f < 128} table[v(c)*W + idx[c*T + s], f]
//   v(c)    = c % (n_rows / W),  W = window
//
// Replaces the Pallas TPU probe `make_onehot`
// (scripts/microbench_gather7.py:100, call :111). There the rows are picked
// by a one-hot [T, W] x [W, 128] product on the matrix unit, which is how a
// TPU selects rows from a VMEM-resident window; the function is "sum of the
// window's rows that idx names". Here the window is staged in shared memory
// and the rows are selected there by index: no product, no one-hot matrix.
//
// What bounds it on an H100: bytes. The bound counts the rows that idx names
// once, the indices and the output. What the design moves is more: every
// chunk stages its whole window (W * 512 B from L2 or device memory) and
// then reads T rows out of shared memory, so its time grows with W.
//
// Tiling. A whole window does not fit a block's shared memory (W = 1024 is
// 512 KB against 227 KB), so the 128 columns are tiled: a tile holds all W
// rows of tc columns, tc the largest power of two with W * tc <= 16384
// floats (64 KB), at most 128:
//     W = 256 -> tc = 64 (2 tiles),  W = 512 -> tc = 32 (4 tiles),
//     W = 1024 -> tc = 16 (8 tiles); W <= 4096 (tc >= 4).
// 64 KB a block (plus T indices) lets three blocks share an SM, so one
// block's staging overlaps another's selection. Anything above 48 KB is
// dynamic shared memory behind cudaFuncSetAttribute.
//
// Design (simple and deterministic):
//   * one thread block a chunk, 256 threads; the chunk's T indices are
//     loaded into shared memory once;
//   * per column tile: the block copies the tile from global memory as
//     float4 (tc/4 a row, neighbouring threads on neighbouring addresses),
//     __syncthreads, then every thread takes (slot, float4) items, reads
//     tile[idx[slot]] from shared memory and adds its four floats;
//   * fp32 partial sums per thread over all tiles, one shuffle reduction per
//     warp and one through shared memory per block; no atomics.
// Indices outside [0, W) are clamped into it, so no read leaves the tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowVec4 = 32;          // a 128-float row as float4
constexpr int kTileVec4 = 16384 / 4;  // a tile: 64 KB as float4
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  return v;
}

// q4 = tc / 4: float4 per window row in a tile. Dynamic shared memory:
// window * q4 float4 of tile, then `chunk` ints of indices.
__global__ void __launch_bounds__(kThreads)
gather_window_sum_kernel(const float4* __restrict__ table,
                         const int* __restrict__ idx, float* __restrict__ out,
                         int n_windows, int window, int chunk, int q4) {
  extern __shared__ float4 smem[];
  __shared__ float warp_part[kThreads / 32];
  float4* tile = smem;
  int* slot_idx = reinterpret_cast<int*>(smem + (size_t)window * q4);
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const float4* win = table + (size_t)(c % n_windows) * window * kRowVec4;
  for (int s = tid; s < chunk; s += kThreads)
    slot_idx[s] = min(max(__ldg(idx + (size_t)c * chunk + s), 0), window - 1);
  float acc = 0.f;
  const int tile_items = window * q4;
  const int slot_items = chunk * q4;
  for (int t0 = 0; t0 < kRowVec4; t0 += q4) {
    __syncthreads();  // the indices are in; the last tile has been read
    for (int i = tid; i < tile_items; i += kThreads) {
      const int r = i / q4;
      const int q = i - r * q4;
      tile[i] = __ldg(win + (size_t)r * kRowVec4 + t0 + q);
    }
    __syncthreads();
    for (int i = tid; i < slot_items; i += kThreads) {
      const int s = i / q4;
      const int q = i - s * q4;
      const float4 v = tile[slot_idx[s] * q4 + q];
      acc += (v.x + v.y) + (v.z + v.w);
    }
  }
  acc = warp_sum(acc);
  if ((tid & 31) == 0) warp_part[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_part[w];
    out[c] = total;
  }
}

}  // namespace

// Launches K5 on `stream` (a cudaStream_t). table is [n_rows, 128] fp32
// row-major and 16-byte aligned, idx has n_chunks * chunk int32 entries
// (clamped into [0, window)), out n_chunks floats; chunk <= 4096 (the indices share the
// block's shared memory), n_rows >= window. Returns the cudaError_t of the
// attribute call or of the launch (0 on success).
extern "C" int gather_window_sum_f32(const float* table, const int* idx,
                                     float* out, int n_rows, int n_chunks,
                                     int chunk, int window, void* stream) {
  if (n_chunks <= 0 || chunk <= 0) return 0;
  if (window <= 0 || window > kTileVec4 || n_rows < window || chunk > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  int q4 = kRowVec4;  // tc / 4, a power of two
  while (window * q4 > kTileVec4) q4 >>= 1;
  const size_t smem_bytes =
      (size_t)window * q4 * sizeof(float4) + (size_t)chunk * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      gather_window_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_window_sum_kernel<<<n_chunks, kThreads, smem_bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), idx, out, n_rows / window,
      window, chunk, q4);
  return static_cast<int>(cudaGetLastError());
}
