// K6 for Hopper: per-chunk sum of table rows named anywhere in the table,
// each row fetched by its own asynchronous copy into a shared-memory ring.
//
//   part[c] = sum_{s < T} sum_{f < 128} table[idx[c*T + s], f]
//
// Replaces the Pallas TPU probe `make_row_dma`
// (scripts/microbench_gather7.py:129, call :165). There the chunk's indices
// sit in SMEM and every row is one HBM->VMEM `make_async_copy` with
// `outstanding` (8) semaphores: start the first 8, then wait for the oldest,
// add its row, start the next. The same pipeline here is `cp.async`: 16 bytes
// a thread, a warp a 512-byte row, a ring of `outstanding` row stages per
// warp in shared memory, `cp.async.commit_group` after each row and
// `cp.async.wait_group outstanding-1` before the oldest is summed.
//
// What bounds it on an H100: bytes. It must read the distinct rows that idx
// names once (512 B each; the indices range over the whole table, 51 MB at
// the probe's size against 50 MB of L2), the indices and write one float a
// chunk. With random rows the time is set by how many bytes are in flight:
// `outstanding` x 512 B per warp, 8 warps a block.
//
// Design (simple and deterministic):
//   * one thread block a chunk, 8 warps; the chunk's T indices are loaded
//     into shared memory once (as the TPU kernel keeps them in SMEM);
//   * warp w owns slots w, w + 8, ... in that order and a private ring of
//     DEPTH stages; every lane reads back exactly the 16 bytes it copied
//     itself, so the wait on its own copy groups is the only ordering needed
//     (no barrier inside the loop);
//   * `wait_group` takes a compile-time count, so DEPTH is a template
//     parameter, instantiated for 1, 2, 4 and 8;
//   * a group is committed in every iteration, empty once the slots run out,
//     so that "all but the newest DEPTH-1 groups" always means "the oldest
//     outstanding row";
//   * fp32 partial sums per lane, one shuffle reduction per warp and one
//     through shared memory per block; no atomics.
// Rows are 512-byte aligned because the table is [n_rows, 128] fp32,
// contiguous, on a 16-byte aligned base: the wrapper checks that. Indices
// outside [0, n_rows) are clamped into it, so no copy leaves the table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowFloats = 128;
constexpr int kMaxChunk = 4096;  // the indices share the block's memory
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ void cp_async_16(void* smem_dst,
                                            const void* global_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const size_t src = __cvta_generic_to_global(global_src);
  // .cg: through L2 only; a random row is not read again by this SM
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_all_but() {
  asm volatile("cp.async.wait_group %0;\n" : : "n"(N) : "memory");
}

// Dynamic shared memory: kWarps rings of DEPTH rows of 128 floats, then
// `chunk` ints of indices.
template <int DEPTH>
__global__ void __launch_bounds__(kWarps * 32)
gather_rows_sum_kernel(const float* __restrict__ table,
                       const int* __restrict__ idx, float* __restrict__ out,
                       int n_rows, int chunk) {
  extern __shared__ float4 ring_mem[];
  __shared__ float warp_part[kWarps];
  int* slot_idx = reinterpret_cast<int*>(ring_mem + kWarps * DEPTH * 32);
  const int c = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int s = threadIdx.x; s < chunk; s += kWarps * 32)
    slot_idx[s] = min(max(__ldg(idx + (size_t)c * chunk + s), 0), n_rows - 1);
  __syncthreads();
  // this lane's 16 bytes of each stage of the warp's ring
  float4* mine = ring_mem + (size_t)warp * DEPTH * 32 + lane;
  const float* src = table + lane * 4;
  // slots of this warp: warp, warp + kWarps, ...
  const int n_mine = chunk > warp ? (chunk - warp + kWarps - 1) / kWarps : 0;
#pragma unroll
  for (int k = 0; k < DEPTH; ++k) {
    if (k < n_mine)
      cp_async_16(mine + k * 32,
                  src + (size_t)slot_idx[warp + k * kWarps] * kRowFloats);
    cp_async_commit();
  }
  float acc = 0.f;
  for (int k = 0; k < n_mine; ++k) {
    cp_async_wait_all_but<DEPTH - 1>();  // the copy of slot k has landed
    float4* stage = mine + (k % DEPTH) * 32;
    const float4 v = *stage;
    acc += (v.x + v.y) + (v.z + v.w);
    const int next = k + DEPTH;
    if (next < n_mine)
      cp_async_16(stage,
                  src + (size_t)slot_idx[warp + next * kWarps] * kRowFloats);
    cp_async_commit();
  }
  cp_async_wait_all_but<0>();
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

template <int DEPTH>
cudaError_t launch(const float* table, const int* idx, float* out, int n_rows,
                   int n_chunks, int chunk, cudaStream_t stream) {
  const size_t smem_bytes =
      (size_t)kWarps * DEPTH * kRowFloats * sizeof(float) +
      (size_t)chunk * sizeof(int);
  // ring and indices together can pass the 48 KB a launch gets unasked
  cudaError_t err = cudaFuncSetAttribute(
      gather_rows_sum_kernel<DEPTH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  gather_rows_sum_kernel<DEPTH><<<n_chunks, kWarps * 32, smem_bytes, stream>>>(
      table, idx, out, n_rows, chunk);
  return cudaGetLastError();
}

}  // namespace

// Launches K6 on `stream` (a cudaStream_t). table is [n_rows, 128] fp32
// row-major and 16-byte aligned, idx has n_chunks * chunk int32 entries
// (clamped into [0, n_rows)), out n_chunks floats; chunk <= 4096;
// outstanding is 1, 2, 4 or 8. Returns the cudaError_t of the attribute call
// or the launch (0 on success, cudaErrorInvalidValue for a size it does not
// take).
extern "C" int gather_rows_sum_f32(const float* table, const int* idx,
                                   float* out, int n_rows, int n_chunks,
                                   int chunk, int outstanding, void* stream) {
  if (n_chunks <= 0 || chunk <= 0) return 0;
  if (n_rows <= 0 || chunk > kMaxChunk ||
      (reinterpret_cast<uintptr_t>(table) & 15u))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (outstanding) {
    case 1: return static_cast<int>(launch<1>(table, idx, out, n_rows, n_chunks, chunk, s));
    case 2: return static_cast<int>(launch<2>(table, idx, out, n_rows, n_chunks, chunk, s));
    case 4: return static_cast<int>(launch<4>(table, idx, out, n_rows, n_chunks, chunk, s));
    case 8: return static_cast<int>(launch<8>(table, idx, out, n_rows, n_chunks, chunk, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
