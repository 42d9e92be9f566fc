// K1 for Hopper: CSR SpMM with the source gather fused in.
//
//   out[r, :] = sum_{e in [row_ptr[r], row_ptr[r+1])} w[e] * x[col[e], :]
//
// Replaces the Pallas TPU kernel `sorted_segment_matmul`
// (cogdl_tpu/ops/pallas/segment_kernels.py:294, body `_make_seg_mm_kernel`).
// That kernel summed an [E_k, F] message stream that XLA had gathered
// beforehand, routed through one-hot MXU matmuls over 1024-slot chunks and
// 128-row tiles. None of that layout is part of the function: here the
// gather happens inside the kernel, so no [E, F] message tensor exists.
//
// One kernel serves both directions of the GCN SpMM: the forward runs over
// CSR(A), the backward dX = A^T G over CSR(A^T) (the CSC of A).
//
// What bounds it on an H100: bytes. Per call it must read row_ptr, col and w
// once, the feature table x once and write out once; the arithmetic is
// 2*E*F flops, far below the card's fp32 rate. The x rows are read once per
// incident edge, so the traffic that sets the time is E*F*4 bytes of
// gathers, served from L2 when x fits there (100k x 128 fp32 = 51 MB), and
// what a design can lose on top of that is balance: the rows of CSR(A^T) of
// a power-law graph run from 1 edge to tens of thousands.
//
// Design: the work is cut by edges (spmm_chunk.cuh). One warp owns a chunk
// of about T consecutive edges of the flat edge array, so every warp has the
// same work whatever the degrees; rows inside a chunk are written by that
// warp, the rows longer than T leave one partial sum a chunk in a scratch
// table that holds nothing else, and a second small kernel adds them in
// chunk order. Rows without an
// edge, which no chunk names, are zeroed by extra blocks of the first launch.
// fp32 accumulation, no atomics, one writer per output element: the result
// does not depend on scheduling.
//
// A structure without a row longer than T (the schedule records that: its
// list of cut rows is empty) may take the row-a-warp kernels below instead:
// one warp a row, the 32 lanes across the feature columns, no schedule read.
// The caller chooses between the two by that property of the graph.

#include "spmm_chunk.cuh"

namespace {

using spmm_chunk::aligned16;
using spmm_chunk::fma_to;
using spmm_chunk::kFullMask;
using spmm_chunk::kWarpsPerBlock;
using spmm_chunk::set_zero;

// One warp a row. x and out are tables of fv elements of V (float4 or
// float) a row; the last 32-element group is masked.
template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_csr_rows_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ col, const float* __restrict__ w,
                     const V* __restrict__ x, V* __restrict__ out, int n_rows,
                     int fv) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // warp-uniform: the whole warp leaves
  const int start = row_ptr[row];
  const int end = row_ptr[row + 1];
  for (int base = 0; base < fv; base += 32) {
    const int f = base + lane;
    const bool active = f < fv;
    V acc;
    set_zero(acc);
    for (int e0 = start; e0 < end; e0 += 32) {
      const int e = e0 + lane;
      int c = 0;
      float wv = 0.f;
      if (e < end) {
        c = __ldg(col + e);
        wv = __ldg(w + e);
      }
      const int n = min(32, end - e0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int cj = __shfl_sync(kFullMask, c, j);
        const float wj = __shfl_sync(kFullMask, wv, j);
        if (active) fma_to(acc, wj, __ldg(x + (size_t)cj * fv + f));
      }
    }
    if (active) out[(size_t)row * fv + f] = acc;
  }
}

}  // namespace

// Launches K1 on `stream` (a cudaStream_t). x and out are [n_rows, n_feat]
// fp32 row-major; row_ptr has n_rows + 1 entries. rows != 0: the row-a-warp
// kernel runs and the schedule is not read. Otherwise erow, chunk_start and
// piece_start (n_chunks + 1 entries each) and cross (n_cross triples) are the
// schedule of this row_ptr and partial is fp32 scratch of
// [piece_start[n_chunks], n_feat], needed only when n_cross > 0. Adds the
// number of CUDA kernels started to *n_kernels and returns the cudaError_t of
// the first launch that failed (0 on success).
extern "C" int spmm_csr_f32(const int* row_ptr, const int* col, const float* w,
                            const float* x, float* out, int n_rows, int n_feat,
                            const int* erow, const int* chunk_start,
                            const int* piece_start, int n_chunks,
                            const int* cross, int n_cross, float* partial,
                            int rows, int* n_kernels, void* stream) {
  if (n_rows <= 0 || n_feat <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!rows) {
    return spmm_chunk::launch<false>(row_ptr, col, w, x, out, n_rows, n_feat,
                                     erow, chunk_start, piece_start, n_chunks,
                                     cross, n_cross, partial, s, n_kernels);
  }
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (n_feat % 4 == 0 && aligned16(x) && aligned16(out)) {
    spmm_csr_rows_kernel<float4><<<grid, block, 0, s>>>(
        row_ptr, col, w, reinterpret_cast<const float4*>(x),
        reinterpret_cast<float4*>(out), n_rows, n_feat / 4);
  } else {
    spmm_csr_rows_kernel<float><<<grid, block, 0, s>>>(row_ptr, col, w, x, out,
                                                       n_rows, n_feat);
  }
  ++*n_kernels;
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmm_csr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
