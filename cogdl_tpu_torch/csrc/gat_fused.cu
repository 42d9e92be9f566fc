// K3 for Hopper: the fused GAT attention pass, in three modes.
//
// Replaces the Pallas TPU kernel `_make_gat_pass_kernel`, launched by
// `_gat_pass` (cogdl_tpu/ops/pallas/segment_kernels.py:975, pallas_call at
// :1067) and driven three times per layer and step by the custom VJP
// `gat_fused_p`. For an edge e from source c into destination r and a head h,
// with fp32 throughout:
//
//   pre   = sd[r,h] + ss[c,h]
//   slope = pre > 0 ? 1 : alpha
//   m     = lrelu(sd[r,h] + smax[h])      (smax = max of ss over all rows: an
//                                          exact bound of the row's scores)
//   ex    = exp(pre * slope - m)
//   keep  = murmur-style hash of (key[e], h) < threshold ? 1/(1-p) : 0
//           key[e] = orig[e] ^ seed                              (edge-id key)
//                 or (r * 0x9E3779B1) ^ (c * 0x85EBCA77) ^ seed  (coordinate key)
//
//   mode fwd  (grouped by r, CSR):  num[r] = sum_e ex*keep*h2[c]
//                                   den[r] = sum_e ex
//   mode dsd  (grouped by r, CSR):  dsd[r,h] = sum_e ds[e,h]
//   mode dsrc (grouped by c, CSC):  dh2[c] = sum_e ex*keep*dagg[r]
//                                   dss[c,h] = sum_e ds[e,h]
//   with ds = (keep * <dagg[r,h,:], h2[c,h,:]> + dden[r,h]) * ex * slope.
//
// The TPU kernel routed an [E_k, W] stream that XLA had gathered beforehand
// through one-hot MXU matmuls over 1024-slot chunks, with every H-wide value
// spread over 128 lanes. None of that is part of the function. Here the
// gathers happen inside the kernel and no per-edge tensor reaches memory;
// the dropout mask is hashed in registers from the edge's position in the
// graph's edge list, bit for bit as the TPU kernel hashes it (:819-828), or,
// as that kernel does on its blocked layouts (:806-817), from the edge's
// (dst, src) coordinates, which needs no stored edge ids.
//
// The accumulating form (the TPU kernel's `acc` operand, :1043-1075, driven
// once per mega-block of a source panel by `_gat_apply`, :1104-1160): with
// `accum` set, `ptr` holds one panel's row pointers of a panel-major CSR
// (offsets into the flat idx, global indices), the sums are added to what
// out_vec and out_head hold, and a row without edges in the panel is left
// untouched. The softmax shift m does not depend on the panel, so the
// partial sums of all panels add up to the single-shot result.
//
// What bounds it on an H100: bytes. Per row it reads its edges' indices (and
// orig ids under dropout), one H2 (or dagg) row and a few H-wide score rows
// per edge, and writes one output row; the arithmetic is a few flops and one
// exp per (edge, head) and one or two FMAs per (edge, column), far below the
// card's fp32 rate.
//
// Design (simple and deterministic; load balancing and staged gathers are
// later work):
//   * one warp per grouping row, the 32 lanes across the H*D columns (four
//     columns a lane as float4 when D % 4 == 0 and the tables are 16-byte
//     aligned, else one column a lane; NG groups of 32 lanes' columns per
//     pass over the edges, more columns in further passes);
//   * edges in batches of 32: each lane loads one edge's neighbour (and orig
//     id), then the warp scores the batch's 32*H (edge, head) pairs in
//     parallel into shared memory, then walks the batch, each lane reading
//     its head's weight from shared memory (a broadcast) and FMA-ing the
//     gathered neighbour row;
//   * the per-head dots of dsd and dsrc need no per-edge reduction across
//     lanes, since one factor is constant along the row: dsd accumulates
//     sum_e ex*slope*keep*h2[c] and dots it with dagg[r] once at the row's
//     end, dsrc accumulates sum_e ex*slope*keep*dagg[r] and dots it with
//     h2[c]. This sums in another order than the per-edge formula above;
//   * per-head sums are taken by lane h over the batch in order; each output
//     row is written once, without atomics, so results do not depend on
//     scheduling.
// H <= 32 (one lane a head). A row with many edges (the hub columns of the
// CSC on power-law graphs) runs serially on one warp: a known long tail.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kFwd = 0, kDsd = 1, kDsrc = 2;

struct GatArgs {
  const int* ptr;          // [n_rows + 1] row offsets of the grouping
  const int* idx;          // [nnz] the neighbour of each edge
  const int* orig;         // [nnz] the edge's position in the edge list
  const long long* seed;   // [1] dropout seed (read only when drop)
  const float* sd;         // [n, H] destination score half
  const float* ss;         // [n, H] source score half
  const float* smax;       // [H] max of ss over all rows
  const float* h2;         // [n, H*D] transformed features
  const float* dagg;       // [n, H*D] g / den (backward modes)
  const float* dden;       // [n, H] -sum_d g*out / den (backward modes)
  float* out_vec;          // [n, H*D] num (fwd) or dh2 (dsrc)
  float* out_head;         // [n, H] den (fwd), dsd (dsd) or dss (dsrc)
  float* keep_out;         // [nnz, H] the keep scales, or null
  int n_rows, H, D;
  float alpha, inv_keep;
  unsigned thresh;
  int drop;
  int coord_key;           // hash the (dst, src) coordinates, not orig
  int accum;               // add into out_vec / out_head, skip empty rows
};

__device__ __forceinline__ float keep_scale(unsigned key, unsigned H,
                                            unsigned h, unsigned thresh,
                                            float inv_keep) {
  unsigned hx = key * H + h;
  hx = hx * 747796405u + 2891336453u;
  hx ^= hx >> 16;
  hx *= 0x85EBCA6Bu;
  hx ^= hx >> 13;
  hx *= 0xC2B2AE35u;
  hx ^= hx >> 16;
  return hx < thresh ? inv_keep : 0.f;
}

template <int VEC> struct VecT;
template <> struct VecT<1> { using T = float; };
template <> struct VecT<4> { using T = float4; };

__device__ __forceinline__ void vzero(float& a) { a = 0.f; }
__device__ __forceinline__ void vzero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void vfma(float& acc, float s, float v) {
  acc = fmaf(s, v, acc);
}
__device__ __forceinline__ void vfma(float4& acc, float s, const float4& v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}
__device__ __forceinline__ float vdot(float a, float b) { return a * b; }
__device__ __forceinline__ float vdot(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Shared memory a warp uses: NARR pair arrays of 32*H floats, and NG*32
// floats for the per-head dots.
template <int MODE>
__host__ __device__ constexpr int pair_arrays() {
  return MODE == kDsrc ? 3 : 2;
}

template <int MODE, int NG>
int warp_smem_floats(int H) { return pair_arrays<MODE>() * 32 * H + NG * 32; }

template <int MODE, int VEC, int NG>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_pass_kernel(const GatArgs a) {
  using T = typename VecT<VEC>::T;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  const int H = a.H, D = a.D;
  const int P = 32 * H;
  float* pa = smem + warp * (pair_arrays<MODE>() * P + NG * 32);
  float* pb = pa + P;
  float* pc = pb + P;                           // dsrc only
  float* red = pa + pair_arrays<MODE>() * P;
  if (row >= a.n_rows) return;                  // warp-uniform
  const int start = a.ptr[row];
  const int end = a.ptr[row + 1];
  if (a.accum && start >= end) return;          // the outputs keep this row
  const unsigned seed = a.drop ? static_cast<unsigned>(*a.seed) : 0u;
  const int units = H * D / VEC;                // T-wide columns of a row
  const int chunk = NG * 32;
  // the gathered neighbour table, and the row's own table for the dots
  const T* nbr_tab = reinterpret_cast<const T*>(MODE == kDsrc ? a.dagg : a.h2);
  const T* own_tab = reinterpret_cast<const T*>(MODE == kDsd ? a.dagg : a.h2);
  float head_sum = 0.f;   // lane h: den (fwd), sum ex*slope (dsd),
                          //         sum dden*ex*slope (dsrc)
  float head_dot = 0.f;   // lane h: the per-head dot (dsd, dsrc)

  for (int u0 = 0; u0 < units; u0 += chunk) {
    const bool first = u0 == 0;
    T acc_a[NG], acc_b[NG];
    int head[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      vzero(acc_a[g]);
      vzero(acc_b[g]);
      const int u = u0 + g * 32 + lane;
      head[g] = u < units ? (u * VEC) / D : -1;
    }
    for (int e0 = start; e0 < end; e0 += 32) {
      const int nb = min(32, end - e0);
      int my_nbr = 0, my_orig = 0;
      if (lane < nb) {
        my_nbr = __ldg(a.idx + e0 + lane);
        if (a.drop && !a.coord_key) my_orig = __ldg(a.orig + e0 + lane);
      }
      // score the batch's (edge, head) pairs, pair p = edge j * H + head h
      const int npair = nb * H;
      for (int p0 = 0; p0 < npair; p0 += 32) {
        const int p = p0 + lane;
        const int j = p < npair ? p / H : 0;
        const int nbr = __shfl_sync(kFullMask, my_nbr, j);
        const int org = __shfl_sync(kFullMask, my_orig, j);
        if (p < npair) {
          const int h = p - j * H;
          const int dst = MODE == kDsrc ? nbr : row;
          const int src = MODE == kDsrc ? row : nbr;
          const float sdv = __ldg(a.sd + (size_t)dst * H + h);
          const float pre = sdv + __ldg(a.ss + (size_t)src * H + h);
          const float slope = pre > 0.f ? 1.f : a.alpha;
          float m = sdv + __ldg(a.smax + h);
          m = m > 0.f ? m : a.alpha * m;
          const float ex = expf(pre * slope - m);
          float exk = ex;
          if (a.drop) {
            const unsigned key =
                a.coord_key ? (static_cast<unsigned>(dst) * 0x9E3779B1u) ^
                                  (static_cast<unsigned>(src) * 0x85EBCA77u) ^
                                  seed
                            : static_cast<unsigned>(org) ^ seed;
            const float kv = keep_scale(key, H, h, a.thresh, a.inv_keep);
            exk = ex * kv;
            if (a.keep_out != nullptr && first)
              a.keep_out[(size_t)(e0 + j) * H + h] = kv;
          } else if (a.keep_out != nullptr && first) {
            a.keep_out[(size_t)(e0 + j) * H + h] = 1.f;
          }
          if (MODE == kFwd) {
            pa[p] = exk;
            pb[p] = ex;
          } else if (MODE == kDsd) {
            pa[p] = exk * slope;
            pb[p] = ex * slope;
          } else {
            pa[p] = exk;
            pb[p] = exk * slope;
            pc[p] = __ldg(a.dden + (size_t)dst * H + h) * ex * slope;
          }
        }
      }
      __syncwarp();
      if (first && lane < H) {
        const float* ps = MODE == kDsrc ? pc : pb;
        for (int j = 0; j < nb; ++j) head_sum += ps[j * H + lane];
      }
      // aggregate the batch's gathered neighbour rows
#pragma unroll 2
      for (int j = 0; j < nb; ++j) {
        const int nbr = __shfl_sync(kFullMask, my_nbr, j);
        const T* src_row = nbr_tab + (size_t)nbr * units + u0 + lane;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if (head[g] >= 0) {
            const T v = __ldg(src_row + g * 32);
            vfma(acc_a[g], pa[j * H + head[g]], v);
            if (MODE == kDsrc) vfma(acc_b[g], pb[j * H + head[g]], v);
          }
        }
      }
      __syncwarp();
    }
    // this pass's columns: write the vector output, fold the dots
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int u = u0 + g * 32 + lane;
      if (MODE != kDsd && head[g] >= 0) {
        T* dst = reinterpret_cast<T*>(a.out_vec) + (size_t)row * units + u;
        T v = acc_a[g];
        if (a.accum) vfma(v, 1.f, *dst);
        *dst = v;
      }
      if (MODE != kFwd) {
        float d = 0.f;
        if (head[g] >= 0)
          d = vdot(__ldg(own_tab + (size_t)row * units + u),
                   MODE == kDsd ? acc_a[g] : acc_b[g]);
        red[g * 32 + lane] = d;
      }
    }
    if (MODE != kFwd) {
      __syncwarp();
      if (lane < H) {
        const int lo = max(lane * D / VEC, u0);
        const int hi = min(min((lane + 1) * D / VEC, u0 + chunk), units);
        for (int u = lo; u < hi; ++u) head_dot += red[u - u0];
      }
      __syncwarp();
    }
  }
  if (lane < H) {
    float v = head_sum;
    if (MODE == kDsd)
      v = head_dot + __ldg(a.dden + (size_t)row * H + lane) * head_sum;
    else if (MODE == kDsrc)
      v = head_dot + head_sum;
    float* dst = a.out_head + (size_t)row * H + lane;
    *dst = a.accum ? *dst + v : v;
  }
}

template <int MODE, int VEC, int NG>
int launch(const GatArgs& a, cudaStream_t s) {
  const int smem = kWarpsPerBlock * warp_smem_floats<MODE, NG>(a.H) *
                   static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gat_pass_kernel<MODE, VEC, NG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((a.n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  gat_pass_kernel<MODE, VEC, NG><<<grid, block, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, int VEC>
int launch_ng(const GatArgs& a, int units, cudaStream_t s) {
  if (units <= 32) return launch<MODE, VEC, 1>(a, s);
  if (units <= 64) return launch<MODE, VEC, 2>(a, s);
  return launch<MODE, VEC, 4>(a, s);
}

template <int MODE>
int launch_mode(const GatArgs& a, bool vec4, cudaStream_t s) {
  const int hd = a.H * a.D;
  return vec4 ? launch_ng<MODE, 4>(a, hd / 4, s)
              : launch_ng<MODE, 1>(a, hd, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Launches one K3 pass on `stream` (a cudaStream_t). mode 0 = fwd, 1 = dsd,
// 2 = dsrc. Tables are fp32 row-major; a mode reads and writes only its own
// (fwd: sd ss smax h2 -> out_vec=num, out_head=den; dsd: sd ss smax h2 dagg
// dden -> out_head=dsd; dsrc: the same inputs -> out_vec=dh2, out_head=dss).
// `seed` is read only when drop != 0, `orig` only when drop != 0 and
// coord_key == 0; keep_out may be null. With accum != 0 the outputs are
// added to and rows without edges are skipped. Returns the cudaError_t of the launch (0 on success); 1 (invalid value)
// for an unknown mode or H outside [1, 32].
extern "C" int gat_pass_f32(int mode, const int* ptr, const int* idx,
                            const int* orig, const long long* seed,
                            const float* sd, const float* ss,
                            const float* smax, const float* h2,
                            const float* dagg, const float* dden,
                            float* out_vec, float* out_head, float* keep_out,
                            int n_rows, int H, int D, float alpha,
                            float inv_keep, unsigned thresh, int drop,
                            int coord_key, int accum, void* stream) {
  if (n_rows <= 0) return 0;
  if (H < 1 || H > 32 || D < 1 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const GatArgs a{ptr, idx, orig, seed, sd, ss, smax, h2, dagg, dden,
                  out_vec, out_head, keep_out, n_rows, H, D, alpha,
                  inv_keep, thresh, drop, coord_key, accum};
  const bool vec4 = D % 4 == 0 && aligned16(h2) &&
                    (dagg == nullptr || aligned16(dagg)) &&
                    (out_vec == nullptr || aligned16(out_vec));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFwd: return launch_mode<kFwd>(a, vec4, s);
    case kDsd: return launch_mode<kDsd>(a, vec4, s);
    default: return launch_mode<kDsrc>(a, vec4, s);
  }
}

extern "C" const char* gat_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
