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
// w arrays, global column indices), and one launch covers the panel.
//
// What bounds it on an H100: bytes. A call reads the panel's row pointers,
// its col and w entries, the rows of x that they name (all inside the
// panel's slice, so they can stay in L2) and the rows of acc it adds to, and
// writes those rows back; 2 flops per (edge, column) are far below the fp32
// rate. Over P panels acc is read and written up to P times, the price of
// gathering from L2-sized slices.
//
// Design (K1's, plus the read-modify-write; simple and deterministic):
//   * one warp per destination row, the 32 lanes across feature columns
//     (float4 when F % 4 == 0 and both tables are 16-byte aligned);
//   * a row without edges in this panel returns before touching acc;
//   * each lane loads one (col, w) pair of a 32-edge batch and the warp
//     broadcasts them with __shfl_sync; fp32 sums in registers, added to
//     the row of acc once, no atomics. Calls of one direction are
//     serialised on the stream, so the result does not depend on scheduling.
// A row with many edges runs serially on one warp: the same long tail as K1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

// x and acc are viewed as [n_rows, f4] float4 tables (f4 = F / 4).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_csr_accum_vec4_kernel(const int* __restrict__ row_ptr,
                           const int* __restrict__ col,
                           const float* __restrict__ w,
                           const float4* __restrict__ x,
                           float4* __restrict__ acc,
                           int n_rows, int f4) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // warp-uniform: the whole warp leaves
  const int start = row_ptr[row];
  const int end = row_ptr[row + 1];
  if (start >= end) return;   // no edge in this panel: acc keeps its row
  for (int base = 0; base < f4; base += 32) {
    const int f = base + lane;
    const bool active = f < f4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
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
        if (active) fma4(sum, wj, __ldg(x + (size_t)cj * f4 + f));
      }
    }
    if (active) {
      float4* dst = acc + (size_t)row * f4 + f;
      float4 a = *dst;
      a.x += sum.x;
      a.y += sum.y;
      a.z += sum.z;
      a.w += sum.w;
      *dst = a;
    }
  }
}

// Any width: one column a lane, the last 32-column group masked.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_csr_accum_scalar_kernel(const int* __restrict__ row_ptr,
                             const int* __restrict__ col,
                             const float* __restrict__ w,
                             const float* __restrict__ x,
                             float* __restrict__ acc,
                             int n_rows, int n_feat) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int start = row_ptr[row];
  const int end = row_ptr[row + 1];
  if (start >= end) return;
  for (int base = 0; base < n_feat; base += 32) {
    const int f = base + lane;
    const bool active = f < n_feat;
    float sum = 0.f;
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
        if (active) sum = fmaf(wj, __ldg(x + (size_t)cj * n_feat + f), sum);
      }
    }
    if (active) acc[(size_t)row * n_feat + f] += sum;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Launches K2 on `stream` (a cudaStream_t). x and acc are [n_rows, n_feat]
// fp32 row-major and must not overlap; row_ptr has n_rows + 1 entries that
// index col and w. Returns the cudaError_t of the launch (0 on success).
extern "C" int spmm_csr_accum_f32(const int* row_ptr, const int* col,
                                  const float* w, const float* x, float* acc,
                                  int n_rows, int n_feat, void* stream) {
  if (n_rows <= 0 || n_feat <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (n_feat % 4 == 0 && aligned16(x) && aligned16(acc)) {
    spmm_csr_accum_vec4_kernel<<<grid, block, 0, s>>>(
        row_ptr, col, w, reinterpret_cast<const float4*>(x),
        reinterpret_cast<float4*>(acc), n_rows, n_feat / 4);
  } else {
    spmm_csr_accum_scalar_kernel<<<grid, block, 0, s>>>(row_ptr, col, w, x,
                                                        acc, n_rows, n_feat);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmm_csr_accum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
