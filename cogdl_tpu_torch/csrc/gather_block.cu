// K4 for Hopper: per-chunk sum of table rows gathered inside the chunk's own
// block of the table, straight from global memory.
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
// has for it is the plain indexed load.
//
// Block index: the Pallas BlockSpec takes block c of the table for chunk c
// and so leaves the table for c >= n_rows / T (at the script's sizes c runs
// to 3071 over 98 blocks); what the TPU read there is not defined by the
// source. This kernel takes block c % (n_rows / T), which is the Pallas
// kernel wherever that one is in range and is how the one-hot probe (K5)
// wraps its windows.
//
// What bounds it on an H100: bytes. It must read the rows that idx names
// once (512 B each), the int32 indices once, and write one float a chunk;
// the arithmetic is one add per gathered float. The gathered traffic,
// E * 512 B, is what the time follows: one chunk's block is 512 KB and stays
// in L2, but the chunks in flight walk over all blocks, so the working set
// is the whole table.
//
// Design (simple and deterministic):
//   * one thread block a chunk, 8 warps; a warp a gathered row: 32 lanes x
//     float4 = the 512-byte row, read with __ldg;
//   * each lane loads one index of a 32-slot batch, coalesced, and the warp
//     broadcasts them with __shfl_sync; the row loop is unrolled so that
//     several independent row loads are in flight per warp;
//   * fp32 partial sums per lane, one shuffle reduction per warp and one
//     through shared memory per block; out[c] is written once, no atomics.
// Indices outside [0, T) are clamped into it, so no load leaves the block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowVec4 = 32;  // a 128-float row as float4
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
gather_block_sum_kernel(const float4* __restrict__ table,
                        const int* __restrict__ idx,
                        float* __restrict__ out, int n_blocks, int chunk) {
  __shared__ float warp_part[kWarps];
  const int c = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float4* block =
      table + (size_t)(c % n_blocks) * chunk * kRowVec4 + lane;
  const int* my_idx = idx + (size_t)c * chunk;
  float acc = 0.f;
  for (int b = warp * 32; b < chunk; b += kWarps * 32) {
    const int s = b + lane;
    const int i =
        s < chunk ? min(max(__ldg(my_idx + s), 0), chunk - 1) : 0;
    const int n = min(32, chunk - b);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const int r = __shfl_sync(kFullMask, i, j);
      const float4 v = __ldg(block + (size_t)r * kRowVec4);
      acc += (v.x + v.y) + (v.z + v.w);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) warp_part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_part[w];
    out[c] = total;
  }
}

}  // namespace

// Launches K4 on `stream` (a cudaStream_t). table is [n_rows, 128] fp32
// row-major and 16-byte aligned, idx has n_chunks * chunk int32 entries
// (clamped into [0, chunk)), out n_chunks floats; n_rows >= chunk. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int gather_block_sum_f32(const float* table, const int* idx,
                                    float* out, int n_rows, int n_chunks,
                                    int chunk, void* stream) {
  if (n_chunks <= 0 || chunk <= 0) return 0;
  if (n_rows < chunk) return static_cast<int>(cudaErrorInvalidValue);
  gather_block_sum_kernel<<<n_chunks, kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), idx, out, n_rows / chunk, chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
