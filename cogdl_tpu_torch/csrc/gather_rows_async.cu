// K6 for Hopper: per-chunk sum of table rows named anywhere in the table,
// each row fetched by its own asynchronous copy into a shared-memory ring,
// the work spread evenly over every warp the card holds at once.
//
//   out[c] = sum_{s < T} sum_{f < 128} table[clamp(idx[c*T + s]), f]
//
// Replaces the Pallas TPU probe `make_row_dma`
// (scripts/microbench_gather7.py:129, call :165). There the chunk's indices
// sit in SMEM and every row is one HBM->VMEM `make_async_copy` with
// `outstanding` (8) semaphores: start the first 8, then wait for the oldest,
// add its row, start the next. Here each warp keeps a ring of `outstanding`
// row stages in shared memory in the same way: wait for the oldest copy,
// add its row, start the copy `outstanding` rows ahead.
//
// What bounds it on an H100: bytes. It must read the distinct rows that idx
// names once (512 B each; at the probe's size 86k of the table's 100k rows,
// 44 MB, against 50 MB of L2), the indices, and write one float a chunk.
// Every slot's row passes through the L2 all the same (196,608 rows, 101 MB
// at the probe's size), and on the H100 that traffic, not the latency of a
// copy, sets the time: from 32 KB to 128 KB of copies in flight a SM
// (depth 2 to 8 at 4 blocks a SM) the time moved by 5% (chip_smoke.py's
// gather sweep).
//
// Design:
//   * work by slot range, not by chunk. Each chunk is cut into `segments`
//     runs of ceil(T / segments) slots (the cut of gather_tiles.cuh); the
//     (chunk, segment) items, in slot order, are split evenly over all the
//     warps of a grid that covers the card in one wave (gather_kernels.
//     rows_plan: the SMs times 4 blocks of 8 warps, or fewer where fewer
//     fit): warp g takes items [g n / G, (g + 1) n / G) of n over G warps,
//     a contiguous run of slots that may start and end inside a chunk. So
//     no block carries more than one item more than another (one block a
//     chunk put two chunks on 60 of the 132 SMs at the probe's size), and
//     the cut is chosen so that the busiest warp's rows are fewest;
//   * a warp walks its slots with one pipeline that does not drain at item
//     boundaries: `outstanding` copies in flight in its ring, the indices
//     loaded 32 at a time one batch ahead and clamped into [0, n_rows);
//     where an item ends, its sum (fp32, per lane, then a shuffle tree) is
//     written once to its own partial float;
//   * the copy: every lane copies its own 16 bytes of the row with
//     cp.async and waits on its own copy groups (wait_group takes a
//     compile-time count, so the depth is a template parameter). Hopper's
//     bulk copy of the whole row by one lane, completion counted on an
//     mbarrier, measured two to three times slower at depths 4 and 8 on
//     the H100 and is not built;
//   * the bytes in flight come from warps, not from a deeper ring than the
//     caller asked for; four blocks a SM measured as fast as two, three or
//     five, faster than six (all that fit at depth 8) and than one;
//   * deterministic, no atomics: a second small kernel (gather_tiles.cuh's
//     gather_add_partials) adds a chunk's partials in segment order; with
//     one segment a chunk the warp writes out[c] itself. The sum depends
//     only on the cut, not on which warp computed an item, so a second
//     call gives the same bits;
//   * both kernels are programmatic dependent launches: each starts while
//     the kernel before it on the stream ends and waits for its writes
//     (griddepcontrol.wait) before it reads anything, so the second kernel
//     and the next call cost less of the gap between launches;
//   * no attribute is set per launch: the ring is static shared memory
//     (under 48 KB), and the carve-out that lets the blocks share an SM is
//     set once per kernel and device.
// Rows are 512-byte aligned because the table is [n_rows, 128] fp32,
// contiguous, on a 16-byte aligned base: the wrapper checks that.

#include "gather_tiles.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunk = 4096;  // the wrapper's limit, kept

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* smem_dst,
                                            const void* global_src) {
  // .cg: through L2 only; a random row is not read again by this SM
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_addr(smem_dst)),
                 "l"(__cvta_generic_to_global(global_src))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_all_but() {
  asm volatile("cp.async.wait_group %0;\n" : : "n"(N) : "memory");
}

// The first slot of item i: chunk i / segments, run i % segments.
__device__ __forceinline__ long long item_slot(long long i, int chunk,
                                               int segments, int seg_len) {
  const long long c = i / segments;
  const int s = static_cast<int>(i - c * segments);
  return c * chunk + min(s * seg_len, chunk);
}

// dst[i] = the sum of item i's rows, for the items of this warp; DEPTH
// copies in flight a warp.
template <int DEPTH>
__global__ void __launch_bounds__(kThreads)
gather_rows_range_kernel(const float4* __restrict__ table,
                         const int* __restrict__ idx,
                         float* __restrict__ dst, int n_rows, int chunk,
                         int segments, long long n_items) {
  __shared__ __align__(128) float4 ring[kWarps][DEPTH][kRowVec4];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long i0 = g * n_items / n_warps;
  const long long i1 = (g + 1) * n_items / n_warps;
  // Launched as a programmatic dependent of the kernel before it: its
  // blocks take their places while that kernel ends, and wait here for its
  // writes (the table and indices included). Then the partials' sum may
  // start launching; it waits for this grid in the same way.
  asm volatile("griddepcontrol.wait;\n"
               "griddepcontrol.launch_dependents;\n" ::: "memory");
  if (i0 == i1) return;
  const int seg_len = (chunk + segments - 1) / segments;
  const long long start = item_slot(i0, chunk, segments, seg_len);
  const int n = static_cast<int>(item_slot(i1, chunk, segments, seg_len) -
                                 start);
  const int* ids = idx + start;
  float4* mine = &ring[warp][0][0];
  // the indices of slots [base, base + 32) and of the next 32, a lane each
  int base = 0;
  int cur = lane < n ? load_index(ids + lane, n_rows) : 0;
  int nxt = 32 + lane < n ? load_index(ids + 32 + lane, n_rows) : 0;
  // start the copy of slot j (j increases by one a call) into stage j % DEPTH
  auto issue = [&](int j) {
    if (j - base == 32) {
      base += 32;
      cur = nxt;
      const int p = base + 32 + lane;
      nxt = p < n ? load_index(ids + p, n_rows) : 0;
    }
    const int r = __shfl_sync(kFullMask, cur, j - base);
    const float4* src = table + static_cast<size_t>(r) * kRowVec4;
    cp_async_16(mine + (j & (DEPTH - 1)) * kRowVec4 + lane, src + lane);
  };
#pragma unroll
  for (int k = 0; k < DEPTH; ++k) {
    if (k < n) issue(k);
    cp_async_commit();
  }
  long long item = i0;
  int item_end = static_cast<int>(
      item_slot(i0 + 1, chunk, segments, seg_len) - start);
  float acc = 0.f;
  for (int k = 0; k < n; ++k) {
    cp_async_wait_all_but<DEPTH - 1>();  // the copy of slot k has landed
    const float4 v = mine[(k & (DEPTH - 1)) * kRowVec4 + lane];
    acc += (v.x + v.y) + (v.z + v.w);
    if (k + DEPTH < n) issue(k + DEPTH);
    cp_async_commit();
    if (k + 1 == item_end) {
      const float part = warp_sum(acc);
      if (lane == 0) dst[item] = part;
      acc = 0.f;
      ++item;
      if (item < i1)
        item_end = static_cast<int>(
            item_slot(item + 1, chunk, segments, seg_len) - start);
    }
  }
}

// Once per kernel and device: the carve-out at its most shared memory, so
// that as many blocks share an SM as their rings allow.
template <int DEPTH>
cudaError_t prepare() {
  static int set_for = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev == set_for) return err;
  err = cudaFuncSetAttribute(gather_rows_range_kernel<DEPTH>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) set_for = dev;
  return err;
}

template <int DEPTH>
struct Rows {
  static int launch(const float* table, const int* idx, float* dst,
                    int n_rows, int chunk, int segments, long long n_items,
                    int grid, cudaStream_t stream) {
    cudaError_t err = prepare<DEPTH>();
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    cfg.attrs = overlap_attr();
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, gather_rows_range_kernel<DEPTH>,
        reinterpret_cast<const float4*>(table), idx, dst, n_rows, chunk,
        segments, n_items));
  }
  static int per_sm() {
    int n = 0;
    if (prepare<DEPTH>() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, gather_rows_range_kernel<DEPTH>, kThreads, 0) !=
            cudaSuccess)
      return -1;
    return n;
  }
};

// Rows<outstanding>::launch (or ::per_sm); cudaErrorInvalidValue for a
// depth that is not built.
#define GATHER_ROWS_DISPATCH(outstanding, call)                           \
  switch (outstanding) {                                                  \
    case 1: return Rows<1>::call;                                         \
    case 2: return Rows<2>::call;                                         \
    case 4: return Rows<4>::call;                                         \
    case 8: return Rows<8>::call;                                         \
    default: return static_cast<int>(cudaErrorInvalidValue);              \
  }

int launch_rows(const float* table, const int* idx, float* dst, int n_rows,
                int chunk, int segments, long long n_items, int grid,
                int outstanding, cudaStream_t s) {
  GATHER_ROWS_DISPATCH(outstanding, launch(table, idx, dst, n_rows, chunk,
                                           segments, n_items, grid, s))
}

}  // namespace

// Launches K6 on `stream` (a cudaStream_t). table is [n_rows, 128] fp32
// row-major and 16-byte aligned, idx has n_chunks * chunk int32 entries
// (clamped into [0, n_rows)), out n_chunks floats; chunk <= 4096. Each
// chunk is cut into `segments` runs of ceil(chunk / segments) slots, none
// empty (1 <= segments <= chunk, and (segments - 1) runs of that length
// fall short of the chunk), and the items
// are spread over `grid` blocks of 8 warps (gather_kernels.rows_plan; more
// blocks than fit at once still give the right sums, only later);
// partial holds n_chunks * segments floats unless segments is 1 (then it
// may be null). outstanding is 1, 2, 4 or 8. *started gets the number of
// CUDA kernels started.
// Returns a cudaError_t (0 on success, cudaErrorInvalidValue for a size it
// does not take).
extern "C" int gather_rows_sum_f32(const float* table, const int* idx,
                                   float* out, float* partial, int n_rows,
                                   int n_chunks, int chunk, int segments,
                                   int grid, int outstanding, int* started,
                                   void* stream) {
  *started = 0;
  if (n_chunks == 0) return 0;
  if (n_rows <= 0 || n_chunks < 0 || chunk <= 0 || chunk > kMaxChunk ||
      segments < 1 || segments > chunk ||
      (segments - 1) * ((chunk + segments - 1) / segments) >= chunk ||
      grid < 1 ||
      (segments > 1 && partial == nullptr) ||
      (reinterpret_cast<uintptr_t>(table) & 15u))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = segments == 1 ? out : partial;
  const int err = launch_rows(table, idx, dst, n_rows, chunk, segments,
                              static_cast<long long>(n_chunks) * segments,
                              grid, outstanding, s);
  if (err != 0) return err;
  ++*started;
  return static_cast<int>(finish(partial, out, n_chunks, segments, started,
                                 s));
}

// Thread blocks of K6 at this depth that share one SM, as the CUDA runtime
// computes it (-1 on error): with the SM count, the grid.
extern "C" int gather_rows_blocks_per_sm(int outstanding) {
  GATHER_ROWS_DISPATCH(outstanding, per_sm())
}
