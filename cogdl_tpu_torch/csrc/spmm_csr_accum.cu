// K2 for Hopper: the accumulating CSR SpMM, one call per source panel.
//
//   acc[r, :] += sum_{e in [row_ptr[r], row_ptr[r+1])} w[e] * x[col[e], :]
//
// in place; a row with no edge in [row_ptr[r], row_ptr[r+1]) is not touched.
//
// Replaces the Pallas TPU kernel `sorted_segment_matmul_accum`
// (cogdl_tpu/ops/pallas/segment_kernels.py:244, body
// `_make_seg_mm_accum_kernel`), which the blocked streaming loop calls once
// per mega-block of a source panel with the output aliased to the running
// accumulator. That kernel summed an [E_k, F] message block that XLA had
// gathered from the panel's slice of the feature table, through one-hot MXU
// matmuls over 1024-slot chunks and 128-row tiles. Here the gather happens
// inside the kernel and there are no blocks: the caller passes the row
// pointers of one panel of a panel-major CSR (offsets into the flat col and
// w arrays, global column indices), and one call covers the panel.
//
// What bounds it on an H100: bytes. A call reads the panel's row pointers,
// its col and w entries, the rows of x that they name (all inside the
// panel's slice, so they can stay in L2) and the rows of acc it adds to, and
// writes those rows back; 2 flops per (edge, column) are far below the fp32
// rate. Over P panels acc is read and written up to P times, the price of
// gathering from L2-sized slices. A panel of a products-scale graph holds
// 0.4 edges a row and a slice of a 677,146-edge hub row, so neither a warp a
// row nor a row a warp fits it.
//
// Design: K1's edge chunks (spmm_chunk.cuh) with the read-modify-write. One
// warp owns about T consecutive edges of the panel; it names only rows that
// have an edge, so the others keep their values bit for bit and no warp is
// spent on them. A row inside a chunk is added to acc by that warp, once; a
// row longer than T leaves one partial sum a chunk in a scratch table, and
// the second kernel, after the first on the same stream, adds them in chunk
// order and then adds the total to acc, once. fp32 sums, no atomics; the
// calls of one direction are serialised on the stream, so the result does
// not depend on scheduling.

#include "spmm_chunk.cuh"

// Launches K2 on `stream` (a cudaStream_t). x and acc are [n_rows, n_feat]
// fp32 row-major and must not overlap; row_ptr has n_rows + 1 entries that
// index col and w. erow, chunk_start and piece_start (n_chunks + 1 entries
// each) and cross (n_cross triples) are the schedule of this row_ptr, partial
// is fp32 scratch of [piece_start[n_chunks], n_feat], needed only when
// n_cross > 0. Adds the number of CUDA kernels started to *n_kernels and
// returns the cudaError_t of the first launch that failed (0 on success).
extern "C" int spmm_csr_accum_f32(const int* row_ptr, const int* col,
                                  const float* w, const float* x, float* acc,
                                  int n_rows, int n_feat, const int* erow,
                                  const int* chunk_start,
                                  const int* piece_start, int n_chunks,
                                  const int* cross, int n_cross,
                                  float* partial, int* n_kernels,
                                  void* stream) {
  if (n_rows <= 0 || n_feat <= 0) return 0;
  return spmm_chunk::launch<true>(row_ptr, col, w, x, acc, n_rows, n_feat,
                                  erow, chunk_start, piece_start, n_chunks,
                                  cross, n_cross, partial,
                                  static_cast<cudaStream_t>(stream),
                                  n_kernels);
}

extern "C" const char* spmm_csr_accum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
