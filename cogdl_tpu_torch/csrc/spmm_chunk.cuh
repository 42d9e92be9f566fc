// The edge-chunk SpMM shared by K1 (spmm_csr.cu) and K2 (spmm_csr_accum.cu).
//
//   K1: out[r, :]  = sum_{e in [row_ptr[r], row_ptr[r+1])} w[e] * x[col[e], :]
//   K2: acc[r, :] += the same sum, rows without an edge untouched
//
// The work is cut by edges, not by rows. The schedule that is made once with
// the structure (ops/cuda/device_layout.py::build_spmm_schedule) holds
//   * erow[e]         the row of every edge (the flat order of col and w);
//   * chunk_start[c]  the first edge of chunk c, n_chunks + 1 offsets: about
//                     T edges a chunk, a boundary moved back to the start of
//                     its row when that row has at most T edges, so a chunk
//                     holds fewer than 2T edges and only rows longer than T
//                     are cut;
//   * cross[i]        (row, first chunk, last chunk) of every row that is cut,
//                     row < 0 for padding;
//   * piece_start[c]  the partial sums that the chunks before c leave behind,
//                     n_chunks + 1 counts: the scratch holds one row a piece
//                     of a cut row and nothing else.
// One warp owns one chunk, whatever the degree distribution: a hub row of
// 65,676 edges is 513 warps on all SMs at T = 128, and a panel with 0.4
// edges a row starts a warp per 128 edges, not per row.
//
// chunk_kernel: the lanes lie across the feature columns (float4 a lane when
// F % 4 == 0 and the tables are 16-byte aligned, else one float; K elements a
// lane, so F = 47 is one pass with two columns a lane). The warp walks its
// edges once, 32 at a time: each lane loads one (col, w, row) triple,
// coalesced, the next batch's triples are loaded before the current batch is
// used, and U gathered rows of x are requested before the first of them is
// added, so U gathers a lane are in flight. A ballot over the batch marks
// the edges that open another row, and the warp walks from mark to mark, so
// the loop over a row's edges holds no test. At a mark the finished row is
// flushed: a row that lies inside the chunk is written by
// this warp alone (K1: out[r] = sum; K2: acc[r] += sum, once). A chunk
// leaves at most two pieces of cut rows, in the order of its edges: the piece
// of a row that began in an earlier chunk goes to partial[piece_start[c]],
// the piece of a row that continues in the next chunk to
// partial[piece_start[c + 1] - 1]. So the pieces of one row lie side by side,
// in chunk order, from slot piece_start[first + 1] - 1 on.
//
// cross_kernel: one block a cut row adds its last - first + 1 pieces in a
// fixed order (each warp an eighth of them in chunk order, then the eight
// sums in order) and writes the row once. It runs after chunk_kernel on the
// same stream.
//
// No floating-point atomics: every output element has one writer and a fixed
// order of additions, so the result does not depend on scheduling. Within a
// chunk a row's terms are added in edge order, as the plain version's
// index_add on the CPU adds them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace spmm_chunk {

// Gathered rows of x a lane has in flight (U): with one element a lane, and
// with two (float4 and float). More cost registers and buy nothing on an
// H100: enough warps are resident to cover the latency of a gather.
constexpr int kInFlight1 = 3;
constexpr int kInFlight2 = 2;

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void set_zero(float& a) { a = 0.f; }
__device__ __forceinline__ void set_zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void fma_to(float& acc, float s, const float& v) {
  acc = fmaf(s, v, acc);
}
__device__ __forceinline__ void fma_to(float4& acc, float s, const float4& v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}
__device__ __forceinline__ void add_to(float& a, const float& b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// K1 writes the row, K2 adds to it.
template <bool ACCUM, typename V>
__device__ __forceinline__ void put(V* dst, const V& v) {
  if (ACCUM) {
    V a = *dst;
    add_to(a, v);
    *dst = a;
  } else {
    *dst = v;
  }
}

// What a warp keeps of the row it is summing:
//   clear()                       the sum back to zero;
//   add(c_here, w_here, j, stop)  edges [j, stop) of the batch whose (col, w)
//                                 pairs the lanes hold, U gathers in flight;
//   flush<ACCUM>(...)             one finished piece of row `row`: to the
//                                 chunk's head or tail slot of the scratch
//                                 when the row goes on outside the chunk,
//                                 else to the output.
// The lanes lie across the columns: lane l holds elements base + l,
// base + 32 + l, ... (K of them) of the row, V a float4 or a float.
template <typename V, int K, int U>
struct ColumnLanes {
  const V* x;
  int fv;
  int f[K];
  bool on[K];
  V sum[K];

  __device__ __forceinline__ ColumnLanes(const V* x_, int fv_, int base,
                                         int lane)
      : x(x_), fv(fv_) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      f[k] = base + k * 32 + lane;
      on[k] = f[k] < fv;
    }
    clear();
  }

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < K; ++k) set_zero(sum[k]);
  }

  __device__ __forceinline__ void add(int c_here, float w_here, int j,
                                      int stop) {
    for (; j < stop; j += U) {
      float wj[U];
      V v[U][K];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int cj = __shfl_sync(kFullMask, c_here, j + u);
        wj[u] = __shfl_sync(kFullMask, w_here, j + u);
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (j + u < stop && on[k]) v[u][k] = __ldg(x + (size_t)cj * fv + f[k]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j + u < stop) {
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (on[k]) fma_to(sum[k], wj[u], v[u][k]);
        }
      }
    }
  }

  template <bool ACCUM>
  __device__ __forceinline__ void flush(V* out, V* partial, int row,
                                        int head_slot, int tail_slot,
                                        bool open_left, bool open_right) {
    if (open_left || open_right) {
      V* dst = partial + (size_t)(open_left ? head_slot : tail_slot) * fv;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (on[k]) dst[f[k]] = sum[k];
    } else {
      V* dst = out + (size_t)row * fv;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (on[k]) put<ACCUM>(dst + f[k], sum[k]);
    }
  }
};

// One warp a chunk. x, out and partial are tables of fv elements of V (float4
// or float) a row, and a launch covers elements [base, base + 32 K) of every
// row, U gathered rows in flight. Blocks [0, chunk_blocks) take 8 chunks
// each; K1 appends zero_blocks blocks that write zeros into the rows without
// an edge, which no chunk names (32 rows a warp).
template <bool ACCUM, typename V, int K, int U>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 1)
chunk_kernel(const int* __restrict__ row_ptr, int n_rows,
             const int* __restrict__ chunk_start,
             const int* __restrict__ piece_start, int n_chunks,
             int chunk_blocks, const int* __restrict__ erow,
             const int* __restrict__ col, const float* __restrict__ w,
             const V* __restrict__ x, V* __restrict__ out,
             V* __restrict__ partial, int fv, int base) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (blockIdx.x >= chunk_blocks) {
    if (ACCUM) return;
    const int r0 = ((blockIdx.x - chunk_blocks) * kWarpsPerBlock + warp) * 32;
    const int r = r0 + lane;
    const bool empty =
        r < n_rows && __ldg(row_ptr + r) == __ldg(row_ptr + r + 1);
    unsigned todo = __ballot_sync(kFullMask, empty);
    V zero;
    set_zero(zero);
    while (todo) {
      V* dst = out + (size_t)(r0 + __ffs(todo) - 1) * fv;
      todo &= todo - 1;
      for (int i = lane; i < fv; i += 32) dst[i] = zero;
    }
    return;
  }
  const int c = blockIdx.x * kWarpsPerBlock + warp;
  if (c >= n_chunks) return;  // warp-uniform: the whole warp leaves
  const int s = __ldg(chunk_start + c);
  const int e = __ldg(chunk_start + c + 1);
  if (s >= e) return;         // padding behind the panel's last chunk
  int cur = __ldg(erow + s);
  const bool head_open = s > __ldg(row_ptr) && __ldg(erow + s - 1) == cur;
  const bool tail_open = e < __ldg(row_ptr + n_rows) &&
                         __ldg(erow + e) == __ldg(erow + e - 1);
  // the scratch slots of this chunk's pieces; read only where one is open
  const int head_slot = __ldg(piece_start + c);
  const int tail_slot = __ldg(piece_start + c + 1) - 1;
  ColumnLanes<V, K, U> sum(x, fv, base, lane);
  bool first = true;  // no row of this chunk has been flushed yet

  int c_next = 0, r_next = 0;
  float w_next = 0.f;
  if (s + lane < e) {
    c_next = __ldg(col + s + lane);
    w_next = __ldg(w + s + lane);
    r_next = __ldg(erow + s + lane);
  }
  for (int e0 = s; e0 < e; e0 += 32) {
    const int c_here = c_next, r_here = r_next;
    const float w_here = w_next;
    const int ahead = e0 + 32 + lane;
    if (ahead < e) {
      c_next = __ldg(col + ahead);
      w_next = __ldg(w + ahead);
      r_next = __ldg(erow + ahead);
    }
    const int n = min(32, e - e0);
    // bit l: edge e0 + l opens another row than the edge before it
    int r_before = __shfl_up_sync(kFullMask, r_here, 1);
    if (lane == 0) r_before = cur;
    const unsigned opens =
        __ballot_sync(kFullMask, lane < n && r_here != r_before);
    unsigned pending = opens;
    int j = 0;
    while (j < n) {
      const int stop = pending ? __ffs(pending) - 1 : n;
      if (stop == j) {  // edge j opens a row: the one before it is finished
        sum.template flush<ACCUM>(out, partial, cur, head_slot, tail_slot,
                                  first && head_open, false);
        first = false;
        cur = __shfl_sync(kFullMask, r_here, j);
        sum.clear();
        pending &= pending - 1;
        continue;
      }
      sum.add(c_here, w_here, j, stop);  // edges [j, stop) belong to row cur
      j = stop;
    }
  }
  sum.template flush<ACCUM>(out, partial, cur, head_slot, tail_slot,
                            first && head_open, tail_open);
}

// One block a cut row; cross holds (row, first chunk, last chunk) triples.
// The row's last - first + 1 pieces lie side by side in the scratch from slot
// piece_start[first + 1] - 1 on: warp k adds the k-th eighth of them in
// order, eight loads in flight, and warp 0 adds the eight sums in order: a
// fixed tree, so the bits do not depend on scheduling, and a hub row cut into
// hundreds of pieces is not one warp's serial chain.
template <bool ACCUM, typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cross_kernel(const int* __restrict__ cross,
             const int* __restrict__ piece_start,
             const V* __restrict__ partial, V* __restrict__ out, int fv) {
  __shared__ V stage[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = __ldg(cross + 3 * blockIdx.x);
  if (row < 0) return;  // padding behind the panel's last cut row
  const int c0 = __ldg(cross + 3 * blockIdx.x + 1);
  const int pieces = __ldg(cross + 3 * blockIdx.x + 2) - c0 + 1;
  const V* mine = partial + (size_t)(__ldg(piece_start + c0 + 1) - 1) * fv;
  const int share = (pieces + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int lo = warp * share;
  const int hi = min(lo + share, pieces);
  for (int base = 0; base < fv; base += 32) {
    const int f = base + lane;
    if (lo < hi && f < fv) {
      V sum = mine[(size_t)lo * fv + f];
      int i = lo + 1;
      for (; i + 7 < hi; i += 8) {
        V v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = mine[(size_t)(i + u) * fv + f];
#pragma unroll
        for (int u = 0; u < 8; ++u) add_to(sum, v[u]);
      }
      for (; i < hi; ++i) add_to(sum, mine[(size_t)i * fv + f]);
      stage[warp][lane] = sum;
    }
    __syncthreads();
    if (warp == 0 && f < fv) {
      V sum = stage[0][lane];
      for (int k = 1; k * share < pieces; ++k) add_to(sum, stage[k][lane]);
      put<ACCUM>(out + (size_t)row * fv + f, sum);
    }
    __syncthreads();
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <bool ACCUM, typename V>
int launch_as(const int* row_ptr, const int* col, const float* w, const V* x,
              V* out, int n_rows, int fv, const int* erow,
              const int* chunk_start, const int* piece_start, int n_chunks,
              const int* cross, int n_cross, V* partial, cudaStream_t s,
              int* n_kernels) {
  const dim3 block(kWarpsPerBlock * 32);
  const int chunk_blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int rows_per_block = kWarpsPerBlock * 32;
  const int zero_blocks =
      ACCUM ? 0 : (n_rows + rows_per_block - 1) / rows_per_block;
  // one element a lane up to 32 elements a row, else two: 64 a launch
  const int step = fv <= 32 ? 32 : 64;
  for (int base = 0; base < fv; base += step) {
    const int grid = chunk_blocks + (base == 0 ? zero_blocks : 0);
    if (grid == 0) continue;
    if (step == 32) {
      chunk_kernel<ACCUM, V, 1, kInFlight1><<<grid, block, 0, s>>>(
          row_ptr, n_rows, chunk_start, piece_start, n_chunks, chunk_blocks,
          erow, col, w, x, out, partial, fv, base);
    } else {
      chunk_kernel<ACCUM, V, 2, kInFlight2><<<grid, block, 0, s>>>(
          row_ptr, n_rows, chunk_start, piece_start, n_chunks, chunk_blocks,
          erow, col, w, x, out, partial, fv, base);
    }
    ++*n_kernels;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_cross > 0) {
    cross_kernel<ACCUM, V>
        <<<n_cross, block, 0, s>>>(cross, piece_start, partial, out, fv);
    ++*n_kernels;
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

// Launches the chunk kernel and, when rows are cut, the cross kernel, on
// stream `s`. x and out are [n_rows, n_feat] fp32 row-major, partial the
// scratch of piece_start[n_chunks] rows of n_feat floats (read only where
// n_cross > 0). The lanes take float4 where 4 divides n_feat and the tables
// are aligned, else floats, one launch per 64 elements of a row. Adds the
// number of kernels started to *n_kernels and returns the first cudaError_t
// that is not 0.
template <bool ACCUM>
int launch(const int* row_ptr, const int* col, const float* w, const float* x,
           float* out, int n_rows, int n_feat, const int* erow,
           const int* chunk_start, const int* piece_start, int n_chunks,
           const int* cross, int n_cross, float* partial, cudaStream_t s,
           int* n_kernels) {
  if (n_feat % 4 == 0 && aligned16(x) && aligned16(out) &&
      aligned16(partial)) {
    return launch_as<ACCUM, float4>(
        row_ptr, col, w, reinterpret_cast<const float4*>(x),
        reinterpret_cast<float4*>(out), n_rows, n_feat / 4, erow, chunk_start,
        piece_start, n_chunks, cross, n_cross,
        reinterpret_cast<float4*>(partial), s, n_kernels);
  }
  return launch_as<ACCUM, float>(row_ptr, col, w, x, out, n_rows, n_feat, erow,
                                 chunk_start, piece_start, n_chunks, cross,
                                 n_cross, partial, s, n_kernels);
}

}  // namespace spmm_chunk
