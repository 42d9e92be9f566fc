// The PyTorch port's own copy of cogdl_tpu/native/graph_sampler.cpp, built by
// cogdl_tpu_torch/native.py; sample_neighbors and random_walk take their
// thread count and split their work by it.
//
// Native host-side graph sampling runtime (C++17 + OpenMP).
//
// TPU-native equivalent of the reference's C++/C samplers
// (cogdl/operators/sample/sample.cpp: sample_adj/subgraph/coo2csr and
// cogdl/utils/rwalk/rwalk.c: parallel random walks). The TPU consumes
// statically shaped batches, so every function here writes FIXED-SIZE padded
// outputs (pad slots marked with mask=0) that are fed straight to device —
// this keeps the host sampler off the critical path when feeding ogbn-scale
// neighbor sampling (SURVEY.md §7 hard part 4).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// xorshift128+ per-thread PRNG: fast, reproducible per (seed, thread)
struct RngState { uint64_t s0, s1; };

static inline uint64_t xorshift_next(RngState* st) {
  uint64_t x = st->s0;
  const uint64_t y = st->s1;
  st->s0 = y;
  x ^= x << 23;
  st->s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
  return st->s1 + y;
}

static inline RngState seed_rng(uint64_t seed, uint64_t stream) {
  RngState st{seed ^ 0x9E3779B97F4A7C15ULL, stream * 0xBF58476D1CE4E5B9ULL + 1};
  for (int i = 0; i < 8; ++i) xorshift_next(&st);
  return st;
}

// Uniform neighbor fan-out sampling over CSR.
//   indptr[num_nodes+1], indices[E]; seeds[num_seeds]
//   out_src[num_seeds*fanout], out_mask[num_seeds*fanout]
// Matches reference sample_adj semantics (sample.cpp:7-50), with-replacement.
// Runs on num_threads threads (the runtime's default when <= 0); thread t of
// T takes the seeds [num_seeds*t/T, num_seeds*(t+1)/T) with its own stream
// (seed, t+1), so a (seed, T) pair fixes the draws on any machine. Returns T,
// the thread count it ran with.
int sample_neighbors(const int64_t* indptr, const int64_t* indices,
                     const int64_t* seeds, int64_t num_seeds, int64_t fanout,
                     uint64_t seed, int num_threads, int64_t* out_src,
                     uint8_t* out_mask) {
  int ran = 1;
#ifdef _OPENMP
  const int nt = num_threads > 0 ? num_threads : omp_get_max_threads();
#pragma omp parallel num_threads(nt)
#endif
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
    const int nth = omp_get_num_threads();
#else
    const int tid = 0;
    const int nth = 1;
#endif
    if (tid == 0) ran = nth;
    RngState st = seed_rng(seed, (uint64_t)tid + 1);
    const int64_t lo = num_seeds * tid / nth;
    const int64_t hi = num_seeds * (tid + 1) / nth;
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t v = seeds[i];
      const int64_t lo_e = indptr[v], hi_e = indptr[v + 1];
      const int64_t deg = hi_e - lo_e;
      for (int64_t k = 0; k < fanout; ++k) {
        const int64_t slot = i * fanout + k;
        if (deg <= 0) {
          out_src[slot] = v;
          out_mask[slot] = 0;
        } else {
          out_src[slot] = indices[lo_e + (int64_t)(xorshift_next(&st) % (uint64_t)deg)];
          out_mask[slot] = 1;
        }
      }
    }
  }
  return ran;
}

// Parallel uniform random walks with restart probability
// (reference rwalk.c:7-38). out_walks[num_starts * walk_length].
// Runs on num_threads threads (the runtime's default when <= 0); thread t of
// T walks the starts [num_starts*t/T, num_starts*(t+1)/T), in order, with its
// own stream (seed, t+1): a step draws once for the restart test when
// restart_prob > 0, then once for a neighbour when the node has an edge. So a
// (seed, T) pair fixes the walks on any machine. Returns T, the thread count
// it ran with.
int random_walk(const int64_t* indptr, const int64_t* indices,
                const int64_t* starts, int64_t num_starts,
                int64_t walk_length, double restart_prob, uint64_t seed,
                int num_threads, int64_t* out_walks) {
  int ran = 1;
  const uint64_t restart_cut =
      (uint64_t)(restart_prob * (double)UINT64_MAX);
#ifdef _OPENMP
  const int nt = num_threads > 0 ? num_threads : omp_get_max_threads();
#pragma omp parallel num_threads(nt)
#endif
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
    const int nth = omp_get_num_threads();
#else
    const int tid = 0;
    const int nth = 1;
#endif
    if (tid == 0) ran = nth;
    RngState st = seed_rng(seed, (uint64_t)tid + 1);
    const int64_t lo_i = num_starts * tid / nth;
    const int64_t hi_i = num_starts * (tid + 1) / nth;
    for (int64_t i = lo_i; i < hi_i; ++i) {
      int64_t cur = starts[i];
      out_walks[i * walk_length] = cur;
      for (int64_t t = 1; t < walk_length; ++t) {
        if (restart_prob > 0.0 && xorshift_next(&st) < restart_cut) {
          cur = starts[i];
        } else {
          const int64_t lo = indptr[cur], hi = indptr[cur + 1];
          const int64_t deg = hi - lo;
          if (deg > 0)
            cur = indices[lo + (int64_t)(xorshift_next(&st) % (uint64_t)deg)];
        }
        out_walks[i * walk_length + t] = cur;
      }
    }
  }
  return ran;
}

// node2vec second-order biased walks via rejection sampling
// (vectorised host analog of the python fallback; p=return, q=in-out).
void node2vec_walk(const int64_t* indptr, const int64_t* indices,
                   const int64_t* starts, int64_t num_starts,
                   int64_t walk_length, double p, double q, uint64_t seed,
                   int64_t* out_walks) {
  const double inv_p = 1.0 / p, inv_q = 1.0 / q;
  double upper = 1.0;
  if (inv_p > upper) upper = inv_p;
  if (inv_q > upper) upper = inv_q;
#pragma omp parallel
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    RngState st = seed_rng(seed, (uint64_t)tid + 1);
    auto unif = [&st]() {
      return (double)(xorshift_next(&st) >> 11) * (1.0 / 9007199254740992.0);
    };
#pragma omp for schedule(static)
    for (int64_t i = 0; i < num_starts; ++i) {
      int64_t prev = starts[i];
      int64_t cur = prev;
      out_walks[i * walk_length] = cur;
      // first hop uniform
      if (walk_length > 1) {
        const int64_t lo = indptr[cur], hi = indptr[cur + 1];
        if (hi > lo)
          cur = indices[lo + (int64_t)(xorshift_next(&st) % (uint64_t)(hi - lo))];
        out_walks[i * walk_length + 1] = cur;
      }
      for (int64_t t = 2; t < walk_length; ++t) {
        const int64_t lo = indptr[cur], hi = indptr[cur + 1];
        const int64_t deg = hi - lo;
        int64_t nxt = cur;
        if (deg > 0) {
          for (int tries = 0; tries < 16; ++tries) {
            const int64_t cand =
                indices[lo + (int64_t)(xorshift_next(&st) % (uint64_t)deg)];
            double w;
            if (cand == prev) {
              w = inv_p;
            } else {
              // binary search cand in prev's sorted neighbor list
              const int64_t* beg = indices + indptr[prev];
              const int64_t* end = indices + indptr[prev + 1];
              bool is_nbr = false;
              int64_t l = 0, r = (int64_t)(end - beg) - 1;
              while (l <= r) {
                const int64_t m = (l + r) / 2;
                if (beg[m] == cand) { is_nbr = true; break; }
                if (beg[m] < cand) l = m + 1; else r = m - 1;
              }
              w = is_nbr ? 1.0 : inv_q;
            }
            if (unif() < w / upper) { nxt = cand; break; }
            nxt = cand;  // fall back to last candidate if all rejected
          }
        }
        prev = cur;
        cur = nxt;
        out_walks[i * walk_length + t] = cur;
      }
    }
  }
}

// Induced subgraph extraction with relabeling (reference subgraph,
// sample.cpp): nodes[k] sorted ascending; emits compacted edge list.
// Returns number of edges written (≤ max_edges).
int64_t induced_subgraph(const int64_t* indptr, const int64_t* indices,
                         const int64_t* nodes, int64_t num_sub,
                         int64_t num_nodes, int64_t max_edges,
                         int64_t* out_row, int64_t* out_col) {
  std::vector<int64_t> relabel(num_nodes, -1);
  for (int64_t i = 0; i < num_sub; ++i) relabel[nodes[i]] = i;
  int64_t e = 0;
  for (int64_t i = 0; i < num_sub && e < max_edges; ++i) {
    const int64_t v = nodes[i];
    for (int64_t j = indptr[v]; j < indptr[v + 1] && e < max_edges; ++j) {
      const int64_t u = relabel[indices[j]];
      if (u >= 0) {
        out_row[e] = i;
        out_col[e] = u;
        ++e;
      }
    }
  }
  return e;
}

// COO → CSR conversion (reference coo2csr_cpu): rows need not be sorted.
void coo2csr(const int64_t* row, const int64_t* col, int64_t num_edges,
             int64_t num_nodes, int64_t* out_indptr, int64_t* out_indices,
             int64_t* out_perm) {
  std::memset(out_indptr, 0, sizeof(int64_t) * (num_nodes + 1));
  for (int64_t e = 0; e < num_edges; ++e) out_indptr[row[e] + 1]++;
  for (int64_t v = 0; v < num_nodes; ++v) out_indptr[v + 1] += out_indptr[v];
  std::vector<int64_t> cursor(out_indptr, out_indptr + num_nodes);
  for (int64_t e = 0; e < num_edges; ++e) {
    const int64_t pos = cursor[row[e]]++;
    out_indices[pos] = col[e];
    out_perm[pos] = e;
  }
}

int omp_max_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
