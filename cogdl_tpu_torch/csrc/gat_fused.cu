// K3 for Hopper: the fused GAT attention pass, in three modes.
//
// Replaces the Pallas TPU kernel `_make_gat_pass_kernel`
// (cogdl_tpu/ops/pallas/segment_kernels.py:663), launched by `_gat_pass`
// (:975, pallas_call at :1067) and driven three times per layer and step by
// the custom VJP `gat_fused_p` (:1201; `_gat_fwd` :1276, `_gat_bwd` :1351).
// For an edge e from source c into destination r and a head h, fp32
// throughout:
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
// once per mega-block of a source panel by `_gat_apply`, :1085): with
// `accum` set, `ptr` holds one panel's row pointers of a panel-major CSR
// (offsets into the flat idx, global indices), the sums are added to what
// out_vec and out_head hold, and a row without edges in the panel is left
// untouched bit for bit. The softmax shift m does not depend on the panel,
// so the partial sums of all panels add up to the single-shot result.
//
// What bounds it on an H100: bytes. A pass reads its edges' indices (and
// orig ids under dropout), one H2 (or dagg) row and a few H-wide score rows
// per edge, and writes one output row; the arithmetic is a few flops and one
// exp per (edge, head) and one or two FMAs per (edge, column), far below the
// card's fp32 rate. What a design can lose on top of the bytes is balance:
// the rows run from 0 edges to 65,676 (the hub column of the 100k CSC) and
// 677,146 (the hub row at the products scale), and a products panel has
// 2.4 rows without an edge for every edge.
//
// Design: K1/K2's edge chunks (spmm_chunk.cuh, ops/cuda/device_layout.py::
// build_spmm_schedule), applied to K3.
//   * One warp owns one chunk of about T = 128 consecutive edges of the flat
//     edge array; a row of at most T edges is never cut, so every warp has
//     the same work whatever the degrees, and no warp names a row without an
//     edge: the accumulating form never touches those rows, the single-shot
//     form zeroes them with extra blocks of the first launch. Each edge's
//     row comes from erow.
//   * The lanes lie across the H*D columns (four a lane as float4 when
//     D % 4 == 0 and the tables are 16-byte aligned, else one; NG groups of
//     32 lanes' columns). The walk takes 32 edges at a time: each lane loads
//     one edge's neighbour, row (and orig id), the warp scores the batch's
//     (edge, head) pairs into shared memory, a ballot marks the edges that
//     open another row, and the warp walks from mark to mark, gathering the
//     neighbour rows, two or three in flight, and FMA-ing them with the
//     pair's weight read from shared memory (a broadcast).
//   * The per-head dots of dsd and dsrc are linear in the vector summed
//     along the row, and the factor they are dotted with is constant along
//     it (dagg[r] for dsd, h2[c] for dsrc). So at a row's end (or a piece's)
//     the warp takes the dots of the vector it summed: dsd sums
//     ex*slope*keep*h2[c] and dots it with dagg[r], dsrc sums
//     ex*slope*keep*dagg[r] and dots it with h2[c]. This sums in another
//     order than the per-edge formula above.
//   * A row that lies inside one chunk is written (or, in the accumulating
//     form, added once) by that warp alone. A row longer than T leaves one
//     piece a chunk in a scratch that holds nothing else, at
//     piece_start[c] (the end of a row that began earlier) or
//     piece_start[c + 1] - 1 (the start of a row that goes on). A piece is
//     narrow: its dots are taken before it is stored, so it holds num (H*D)
//     and den (H) for fwd, the finished per-head partial
//     dot + dden * sum ex*slope (H) for dsd, and dh2 (H*D) and dss (H) for
//     dsrc. The second kernel, K1's cross_kernel, then adds each cut row's
//     pieces in chunk order and writes (or adds) the row once, in every mode.
//   * Passes: one launch covers the columns of at most 32 heads (one lane a
//     head for the per-head sums) and 128 column units; H up to 128 heads
//     and wide heads take further passes over the same chunks. A pass scores
//     only its heads. A head that a pass boundary cuts is owned by the pass
//     that holds its first column: only that pass adds the head's sums of
//     ex, writes its keep scales and writes (rather than adds) its per-head
//     output, so keep_out is written exactly once per (edge, head).
// No floating-point atomics: each output element has one writer and a fixed
// order of additions, so two calls give the same bits.
//
// The row-a-warp kernel of the first port (one warp a grouping row, 32
// edges scored a batch) stays for structures without a row longer than T
// (the schedule lists no cut row), with at most 32 heads; the wrapper
// chooses it by that statistic, as K1 does.

#include "spmm_chunk.cuh"

namespace {

using spmm_chunk::add_to;
using spmm_chunk::aligned16;
using spmm_chunk::fma_to;
using spmm_chunk::kFullMask;
using spmm_chunk::set_zero;

constexpr int kWarpsPerBlock = 4;
constexpr int kFwd = 0, kDsd = 1, kDsrc = 2;
// one launch of the chunk kernel: at most this many heads (a lane each for
// the per-head sums) and column units (NG <= 4 groups of 32 lanes)
constexpr int kPassHeads = 32;
constexpr int kPassUnits = 128;

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
  // the chunk kernel: the schedule, the scratch and this launch's pass
  const int* erow;         // [nnz] the row of every edge
  const int* chunk_start;  // [n_chunks + 1]
  const int* piece_start;  // [n_chunks + 1]
  int n_chunks, chunk_blocks;
  float* partial_vec;      // [n_pieces, H*D] (fwd, dsrc)
  float* partial_head;     // [n_pieces, H]
  int u0, u1;              // the column units [u0, u1) of this pass
  int h0, nh;              // its heads [h0, h0 + nh)
  int own_first;           // the pass holds head h0's first column
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

__device__ __forceinline__ float vdot(float a, float b) { return a * b; }
__device__ __forceinline__ float vdot(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <typename V> struct Width;
template <> struct Width<float> { static constexpr int value = 1; };
template <> struct Width<float4> { static constexpr int value = 4; };

// Pair arrays a mode keeps in shared memory: fwd (ex*keep, ex), dsd
// (ex*slope*keep, ex*slope), dsrc (ex*keep, ex*slope*keep, dden*ex*slope).
template <int MODE>
__host__ __device__ constexpr int pair_arrays() {
  return MODE == kDsrc ? 3 : 2;
}

// Scores the (edge, head) pairs of one batch of nb <= 32 edges into the
// pair arrays, pair p = edge j * nh + local head l, for the pass's heads
// [h0, h0 + nh). Lane j holds edge j's neighbour, grouping row and orig id;
// e0 is the batch's first edge in the flat arrays. A head the pass owns
// (local head 0 when own_first, the others when own_rest) has its keep
// scale written to keep_out.
template <int MODE>
__device__ __forceinline__ void score_batch(const GatArgs& a, int lane,
                                            int nb, int e0, int my_nbr,
                                            int my_row, int my_orig,
                                            unsigned seed, int h0, int nh,
                                            bool own_first, bool own_rest,
                                            float* pa,
                                            float* pb, float* pc) {
  const int H = a.H;
  const int npair = nb * nh;
  for (int p0 = 0; p0 < npair; p0 += 32) {
    const int p = p0 + lane;
    const int j = p < npair ? p / nh : 0;
    const int nbr = __shfl_sync(kFullMask, my_nbr, j);
    const int grp = __shfl_sync(kFullMask, my_row, j);
    const int org = __shfl_sync(kFullMask, my_orig, j);
    if (p < npair) {
      const int l = p - j * nh;
      const int h = h0 + l;
      const bool owned = l > 0 ? own_rest : own_first;
      const int dst = MODE == kDsrc ? nbr : grp;
      const int src = MODE == kDsrc ? grp : nbr;
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
                              (static_cast<unsigned>(src) * 0x85EBCA77u) ^ seed
                        : static_cast<unsigned>(org) ^ seed;
        const float kv = keep_scale(key, H, h, a.thresh, a.inv_keep);
        exk = ex * kv;
        if (a.keep_out != nullptr && owned)
          a.keep_out[(size_t)(e0 + j) * H + h] = kv;
      } else if (a.keep_out != nullptr && owned) {
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
}

// ---------------------------------------------------------------------------
// The chunk kernel
// ---------------------------------------------------------------------------

// What a warp keeps of the row (or piece) it is summing, over the pass's
// column units: unit u = u0 + g * 32 + lane of group g, its local head hl[g]
// (-1 for a lane past the pass's last unit); head_sum is lane l's sum of
// its head's per-pair head value (fwd ex, dsd ex*slope, dsrc dden*ex*slope).
template <int MODE, typename V, int NG>
struct GatLanes {
  static constexpr int U = NG == 1 ? 3 : 2;  // gathered rows in flight
  V acc_a[NG], acc_b[NG];
  int unit[NG], hl[NG];
  float head_sum;

  __device__ __forceinline__ GatLanes(const GatArgs& a, int lane) {
    const int uph = a.D / Width<V>::value;   // units a head
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int u = a.u0 + g * 32 + lane;
      unit[g] = u;
      hl[g] = u < a.u1 ? u / uph - a.h0 : -1;
    }
    clear();
  }

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      set_zero(acc_a[g]);
      set_zero(acc_b[g]);
    }
    head_sum = 0.f;
  }

  // edges [j, stop) of the batch, all of one row: lane l < nh adds its
  // head's values of ps, every lane gathers the edges' neighbour rows and
  // FMAs them, U requested before the first is added
  __device__ __forceinline__ void add(const V* nbr_tab, int units, int my_nbr,
                                      int j, int stop, int nh, bool sums,
                                      int lane, const float* pa,
                                      const float* pb, const float* ps) {
    if (sums)
      for (int jj = j; jj < stop; ++jj) head_sum += ps[jj * nh + lane];
    for (; j < stop; j += U) {
      V v[U][NG];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int nbr = __shfl_sync(kFullMask, my_nbr, min(j + u, 31));
#pragma unroll
        for (int g = 0; g < NG; ++g)
          if (j + u < stop && hl[g] >= 0)
            v[u][g] = __ldg(nbr_tab + (size_t)nbr * units + unit[g]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j + u < stop) {
          const int base = (j + u) * nh;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            if (hl[g] >= 0) {
              fma_to(acc_a[g], pa[base + hl[g]], v[u][g]);
              if (MODE == kDsrc) fma_to(acc_b[g], pb[base + hl[g]], v[u][g]);
            }
          }
        }
      }
    }
  }

  // One finished row or piece of row `row`: the per-head dots of the
  // summed vector (red: the warp's NG * 32 floats of shared memory), then
  // the vector and the per-head values to the chunk's head or tail slot of
  // the scratch when the row goes on outside the chunk, else to the output.
  __device__ __forceinline__ void flush(const GatArgs& a, int lane, int row,
                                        bool open_left, bool open_right,
                                        int head_slot, int tail_slot,
                                        bool own_first, float* red) {
    const int H = a.H, nh = a.nh, units = a.H * a.D / Width<V>::value;
    const int uph = a.D / Width<V>::value;
    float head_val = 0.f;
    if (MODE != kFwd) {
      const V* own_tab = reinterpret_cast<const V*>(MODE == kDsd ? a.dagg
                                                                 : a.h2);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float d = 0.f;
        if (hl[g] >= 0)
          d = vdot(__ldg(own_tab + (size_t)row * units + unit[g]),
                   MODE == kDsd ? acc_a[g] : acc_b[g]);
        red[g * 32 + lane] = d;
      }
      __syncwarp();
      if (lane < nh) {
        const int lo = max((a.h0 + lane) * uph, a.u0) - a.u0;
        const int hi = min((a.h0 + lane + 1) * uph, a.u1) - a.u0;
        for (int u = lo; u < hi; ++u) head_val += red[u];
      }
      __syncwarp();
    }
    const bool owned = lane < nh && (lane > 0 || own_first);
    if (owned) {
      if (MODE == kFwd)
        head_val = head_sum;
      else if (MODE == kDsd)
        head_val += __ldg(a.dden + (size_t)row * H + a.h0 + lane) * head_sum;
      else
        head_val += head_sum;
    }
    const bool piece = open_left || open_right;
    const size_t slot = open_left ? head_slot : tail_slot;
    if (MODE != kDsd) {
      V* dst = piece ? reinterpret_cast<V*>(a.partial_vec) + slot * units
                     : reinterpret_cast<V*>(a.out_vec) + (size_t)row * units;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (hl[g] >= 0) {
          V v = acc_a[g];
          if (!piece && a.accum) add_to(v, dst[unit[g]]);
          dst[unit[g]] = v;
        }
      }
    }
    if (lane < nh) {
      float* dst = (piece ? a.partial_head + slot * H
                          : a.out_head + (size_t)row * H) + a.h0 + lane;
      // a head owned by an earlier pass, or an output being accumulated,
      // is added to; otherwise this pass writes it
      const bool add = !owned || (!piece && a.accum);
      *dst = add ? *dst + head_val : head_val;
    }
  }
};

// Shared memory a warp of the chunk kernel uses: the pair arrays of 32
// edges times nh heads, and NG * 32 floats for the per-head dots.
template <int MODE, int NG>
__host__ __device__ inline int chunk_warp_floats(int nh) {
  return pair_arrays<MODE>() * 32 * nh + NG * 32;
}

// One warp a chunk. Blocks [0, chunk_blocks) take kWarpsPerBlock chunks
// each; the single-shot form's first pass appends blocks that write zeros
// into the rows without an edge, which no chunk names (32 rows a warp).
template <int MODE, typename V, int NG>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_chunk_kernel(const GatArgs a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int units = a.H * a.D / Width<V>::value;
  if (static_cast<int>(blockIdx.x) >= a.chunk_blocks) {
    const int r0 =
        ((blockIdx.x - a.chunk_blocks) * kWarpsPerBlock + warp) * 32;
    const int r = r0 + lane;
    const bool empty = r < a.n_rows && __ldg(a.ptr + r) == __ldg(a.ptr + r + 1);
    unsigned todo = __ballot_sync(kFullMask, empty);
    V zero;
    set_zero(zero);
    while (todo) {
      const size_t row = r0 + __ffs(todo) - 1;
      todo &= todo - 1;
      if (MODE != kDsd) {
        V* dst = reinterpret_cast<V*>(a.out_vec) + row * units;
        for (int i = lane; i < units; i += 32) dst[i] = zero;
      }
      for (int h = lane; h < a.H; h += 32) a.out_head[row * a.H + h] = 0.f;
    }
    return;
  }
  const int c = blockIdx.x * kWarpsPerBlock + warp;
  if (c >= a.n_chunks) return;   // warp-uniform: the whole warp leaves
  const int s = __ldg(a.chunk_start + c);
  const int e = __ldg(a.chunk_start + c + 1);
  if (s >= e) return;            // padding behind the panel's last chunk
  const int nh = a.nh, h0 = a.h0;
  const bool own_first = a.own_first != 0;
  float* pa = smem + warp * chunk_warp_floats<MODE, NG>(nh);
  float* pb = pa + 32 * nh;
  float* pc = pb + 32 * nh;                     // dsrc only
  float* red = pa + pair_arrays<MODE>() * 32 * nh;
  const float* ps = MODE == kFwd ? pb : (MODE == kDsd ? pb : pc);
  const unsigned seed = a.drop ? static_cast<unsigned>(*a.seed) : 0u;
  const V* nbr_tab = reinterpret_cast<const V*>(MODE == kDsrc ? a.dagg : a.h2);
  const bool sums = lane < nh && (lane > 0 || own_first);

  int cur = __ldg(a.erow + s);
  const bool head_open = s > __ldg(a.ptr) && __ldg(a.erow + s - 1) == cur;
  const bool tail_open = e < __ldg(a.ptr + a.n_rows) &&
                         __ldg(a.erow + e) == __ldg(a.erow + e - 1);
  // the scratch slots of this chunk's pieces; used only where one is open
  const int head_slot = __ldg(a.piece_start + c);
  const int tail_slot = __ldg(a.piece_start + c + 1) - 1;
  GatLanes<MODE, V, NG> lanes(a, lane);
  bool first = true;  // no row of this chunk has been flushed yet

  for (int e0 = s; e0 < e; e0 += 32) {
    const int nb = min(32, e - e0);
    int my_nbr = 0, my_row = cur, my_orig = 0;
    if (lane < nb) {
      my_nbr = __ldg(a.idx + e0 + lane);
      my_row = __ldg(a.erow + e0 + lane);
      if (a.drop && !a.coord_key) my_orig = __ldg(a.orig + e0 + lane);
    }
    score_batch<MODE>(a, lane, nb, e0, my_nbr, my_row, my_orig, seed, h0, nh,
                      own_first, true, pa, pb, pc);
    __syncwarp();
    // bit l: edge e0 + l opens another row than the edge before it
    int r_before = __shfl_up_sync(kFullMask, my_row, 1);
    if (lane == 0) r_before = cur;
    unsigned pending = __ballot_sync(kFullMask, lane < nb && my_row != r_before);
    int j = 0;
    while (j < nb) {
      const int stop = pending ? __ffs(pending) - 1 : nb;
      if (stop == j) {  // edge j opens a row: the one before it is finished
        lanes.flush(a, lane, cur, first && head_open, false, head_slot,
                    tail_slot, own_first, red);
        first = false;
        cur = __shfl_sync(kFullMask, my_row, j);
        lanes.clear();
        pending &= pending - 1;
        continue;
      }
      lanes.add(nbr_tab, units, my_nbr, j, stop, nh, sums, lane, pa, pb, ps);
      j = stop;
    }
    __syncwarp();   // the next batch overwrites the pair arrays
  }
  lanes.flush(a, lane, cur, first && head_open, tail_open, head_slot,
              tail_slot, own_first, red);
}

// ---------------------------------------------------------------------------
// The row-a-warp kernel (structures without a cut row, H <= 32)
// ---------------------------------------------------------------------------

template <int MODE, int NG>
__host__ __device__ inline int row_warp_floats(int H) {
  return pair_arrays<MODE>() * 32 * H + NG * 32;
}

// One warp a grouping row, the 32 lanes across the H*D columns (NG groups
// of 32 lanes' columns a pass over the edges, more columns in further
// passes), edges in batches of 32 scored into shared memory; per-head sums
// by lane h over the batch in order, per-head dots folded at the row's end.
template <int MODE, typename V, int NG>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_rows_kernel(const GatArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  const int H = a.H, D = a.D;
  const int P = 32 * H;
  float* pa = smem + warp * row_warp_floats<MODE, NG>(H);
  float* pb = pa + P;
  float* pc = pb + P;                           // dsrc only
  float* red = pa + pair_arrays<MODE>() * P;
  if (row >= a.n_rows) return;                  // warp-uniform
  const int start = a.ptr[row];
  const int end = a.ptr[row + 1];
  if (a.accum && start >= end) return;          // the outputs keep this row
  const unsigned seed = a.drop ? static_cast<unsigned>(*a.seed) : 0u;
  constexpr int VEC = Width<V>::value;
  const int units = H * D / VEC;                // V-wide columns of a row
  const int chunk = NG * 32;
  // the gathered neighbour table, and the row's own table for the dots
  const V* nbr_tab = reinterpret_cast<const V*>(MODE == kDsrc ? a.dagg : a.h2);
  const V* own_tab = reinterpret_cast<const V*>(MODE == kDsd ? a.dagg : a.h2);
  float head_sum = 0.f;   // lane h: den (fwd), sum ex*slope (dsd),
                          //         sum dden*ex*slope (dsrc)
  float head_dot = 0.f;   // lane h: the per-head dot (dsd, dsrc)

  for (int u0 = 0; u0 < units; u0 += chunk) {
    const bool first = u0 == 0;   // keep_out and head sums: first pass only
    V acc_a[NG], acc_b[NG];
    int head[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      set_zero(acc_a[g]);
      set_zero(acc_b[g]);
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
      score_batch<MODE>(a, lane, nb, e0, my_nbr, row, my_orig, seed, 0, H,
                        first, first, pa, pb, pc);
      __syncwarp();
      if (first && lane < H) {
        const float* ps = MODE == kDsrc ? pc : pb;
        for (int j = 0; j < nb; ++j) head_sum += ps[j * H + lane];
      }
      // aggregate the batch's gathered neighbour rows
#pragma unroll 2
      for (int j = 0; j < nb; ++j) {
        const int nbr = __shfl_sync(kFullMask, my_nbr, j);
        const V* src_row = nbr_tab + (size_t)nbr * units + u0 + lane;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if (head[g] >= 0) {
            const V v = __ldg(src_row + g * 32);
            fma_to(acc_a[g], pa[j * H + head[g]], v);
            if (MODE == kDsrc) fma_to(acc_b[g], pb[j * H + head[g]], v);
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
        V* dst = reinterpret_cast<V*>(a.out_vec) + (size_t)row * units + u;
        V v = acc_a[g];
        if (a.accum) add_to(v, *dst);
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

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename K>
int launch_kernel(K kernel, int grid, int smem, const GatArgs& a,
                  cudaStream_t s, int* n_kernels) {
  if (grid <= 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kWarpsPerBlock * 32, smem, s>>>(a);
  ++*n_kernels;
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, typename V, int NG>
int launch_pass(const GatArgs& a, cudaStream_t s, int* n_kernels) {
  const int smem = kWarpsPerBlock * chunk_warp_floats<MODE, NG>(a.nh) *
                   static_cast<int>(sizeof(float));
  const int zero_blocks =
      a.accum || a.u0 > 0
          ? 0
          : (a.n_rows + kWarpsPerBlock * 32 - 1) / (kWarpsPerBlock * 32);
  return launch_kernel(gat_chunk_kernel<MODE, V, NG>,
                       a.chunk_blocks + zero_blocks, smem, a, s, n_kernels);
}

// The chunk kernel over all column units, a pass a launch, then the cross
// kernel for the cut rows: their vector pieces and their per-head pieces.
template <int MODE, typename V>
int launch_chunks(GatArgs a, const int* cross, int n_cross, cudaStream_t s,
                  int* n_kernels) {
  constexpr int VEC = Width<V>::value;
  const int units = a.H * a.D / VEC;
  const int uph = a.D / VEC;
  a.chunk_blocks = (a.n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  for (int u0 = 0; u0 < units;) {
    const int h0 = u0 / uph;
    const int u1 = min(min(units, u0 + kPassUnits), (h0 + kPassHeads) * uph);
    a.u0 = u0;
    a.u1 = u1;
    a.h0 = h0;
    a.nh = (u1 - 1) / uph - h0 + 1;
    a.own_first = u0 % uph == 0;
    const int n = u1 - u0;
    const int err = n <= 32   ? launch_pass<MODE, V, 1>(a, s, n_kernels)
                    : n <= 64 ? launch_pass<MODE, V, 2>(a, s, n_kernels)
                              : launch_pass<MODE, V, 4>(a, s, n_kernels);
    if (err != 0) return err;
    u0 = u1;
  }
  if (n_cross == 0) return 0;
  const int block = spmm_chunk::kWarpsPerBlock * 32;
  if (MODE != kDsd) {
    if (a.accum)
      spmm_chunk::cross_kernel<true, V><<<n_cross, block, 0, s>>>(
          cross, a.piece_start, reinterpret_cast<const V*>(a.partial_vec),
          reinterpret_cast<V*>(a.out_vec), units);
    else
      spmm_chunk::cross_kernel<false, V><<<n_cross, block, 0, s>>>(
          cross, a.piece_start, reinterpret_cast<const V*>(a.partial_vec),
          reinterpret_cast<V*>(a.out_vec), units);
    ++*n_kernels;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.accum)
    spmm_chunk::cross_kernel<true, float><<<n_cross, block, 0, s>>>(
        cross, a.piece_start, a.partial_head, a.out_head, a.H);
  else
    spmm_chunk::cross_kernel<false, float><<<n_cross, block, 0, s>>>(
        cross, a.piece_start, a.partial_head, a.out_head, a.H);
  ++*n_kernels;
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, typename V>
int launch_rows(const GatArgs& a, cudaStream_t s, int* n_kernels) {
  const int units = a.H * a.D / Width<V>::value;
  const int grid = (a.n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int floats = units <= 32   ? row_warp_floats<MODE, 1>(a.H)
                     : units <= 64 ? row_warp_floats<MODE, 2>(a.H)
                                   : row_warp_floats<MODE, 4>(a.H);
  const int smem = kWarpsPerBlock * floats * static_cast<int>(sizeof(float));
  if (units <= 32)
    return launch_kernel(gat_rows_kernel<MODE, V, 1>, grid, smem, a, s,
                         n_kernels);
  if (units <= 64)
    return launch_kernel(gat_rows_kernel<MODE, V, 2>, grid, smem, a, s,
                         n_kernels);
  return launch_kernel(gat_rows_kernel<MODE, V, 4>, grid, smem, a, s,
                       n_kernels);
}

template <int MODE>
int launch_mode(const GatArgs& a, bool vec4, bool rows, const int* cross,
                int n_cross, cudaStream_t s, int* n_kernels) {
  if (rows)
    return vec4 ? launch_rows<MODE, float4>(a, s, n_kernels)
                : launch_rows<MODE, float>(a, s, n_kernels);
  return vec4 ? launch_chunks<MODE, float4>(a, cross, n_cross, s, n_kernels)
              : launch_chunks<MODE, float>(a, cross, n_cross, s, n_kernels);
}

}  // namespace

// Launches one K3 pass on `stream` (a cudaStream_t). mode 0 = fwd, 1 = dsd,
// 2 = dsrc. Tables are fp32 row-major; a mode reads and writes only its own
// (fwd: sd ss smax h2 -> out_vec=num, out_head=den; dsd: sd ss smax h2 dagg
// dden -> out_head=dsd; dsrc: the same inputs -> out_vec=dh2, out_head=dss).
// `seed` is read only when drop != 0, `orig` only when drop != 0 and
// coord_key == 0; keep_out may be null. With accum != 0 the outputs are
// added to and rows without edges are left as they are.
//
// rows != 0: the row-a-warp kernel (H <= 32), the schedule not read.
// Otherwise erow, chunk_start and piece_start (n_chunks + 1 entries each)
// and cross (n_cross triples) are the schedule of this ptr, partial_vec
// (fp32 [piece_start[n_chunks], H*D], fwd and dsrc) and partial_head (fp32
// [piece_start[n_chunks], H]) the scratch, needed only when n_cross > 0.
// Adds the number of CUDA kernels started to *n_kernels. Returns the
// cudaError_t of the first launch that failed (0 on success); 1 (invalid
// value) for an unknown mode, H outside [1, 128] (or [1, 32] with rows) or
// D < 1.
extern "C" int gat_pass_f32(int mode, const int* ptr, const int* idx,
                            const int* orig, const long long* seed,
                            const float* sd, const float* ss,
                            const float* smax, const float* h2,
                            const float* dagg, const float* dden,
                            float* out_vec, float* out_head, float* keep_out,
                            int n_rows, int H, int D, float alpha,
                            float inv_keep, unsigned thresh, int drop,
                            int coord_key, int accum, const int* erow,
                            const int* chunk_start, const int* piece_start,
                            int n_chunks, const int* cross, int n_cross,
                            float* partial_vec, float* partial_head, int rows,
                            int* n_kernels, void* stream) {
  if (n_rows <= 0) return 0;
  if (H < 1 || H > (rows ? 32 : 128) || D < 1 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  GatArgs a{};
  a.ptr = ptr;
  a.idx = idx;
  a.orig = orig;
  a.seed = seed;
  a.sd = sd;
  a.ss = ss;
  a.smax = smax;
  a.h2 = h2;
  a.dagg = dagg;
  a.dden = dden;
  a.out_vec = out_vec;
  a.out_head = out_head;
  a.keep_out = keep_out;
  a.n_rows = n_rows;
  a.H = H;
  a.D = D;
  a.alpha = alpha;
  a.inv_keep = inv_keep;
  a.thresh = thresh;
  a.drop = drop;
  a.coord_key = coord_key;
  a.accum = accum;
  a.erow = erow;
  a.chunk_start = chunk_start;
  a.piece_start = piece_start;
  a.n_chunks = n_chunks;
  a.partial_vec = partial_vec;
  a.partial_head = partial_head;
  const bool vec4 = D % 4 == 0 && aligned16(h2) &&
                    (dagg == nullptr || aligned16(dagg)) &&
                    (out_vec == nullptr || aligned16(out_vec)) &&
                    (partial_vec == nullptr || aligned16(partial_vec));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFwd:
      return launch_mode<kFwd>(a, vec4, rows, cross, n_cross, s, n_kernels);
    case kDsd:
      return launch_mode<kDsd>(a, vec4, rows, cross, n_cross, s, n_kernels);
    default:
      return launch_mode<kDsrc>(a, vec4, rows, cross, n_cross, s, n_kernels);
  }
}

extern "C" const char* gat_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
