// Rank stage of the fused search kernel: merge of sorted 128-runs,
// segmented run-sums and top-k by (score desc, doc asc), for one
// query's candidate region held by one thread block.
//
// Replaces the k <= 16 branch of the TPU rank pipeline
// (document_search_engine_tpu/ops/rank_pallas.py merge_rank_body,
// lines 94-316). What it computes is the same; how differs:
//
// * Candidates are (key, ci) pairs packed into one 64-bit word,
//   key << 32 | ci, with key = (doc << kb) | slot (kb > 0) or doc
//   (kb == 0) and ci >= 0. A compare-exchange moves the pair as one
//   word, so the TPU network's tie-consistency term is not needed, and
//   kb == 0 (where equal docs from different slots do tie on the key)
//   sorts by (doc, ci), which groups equal docs just the same.
// * The merge is the all-ascending form of the bitonic merge: each
//   level first compares element i with its mirror i ^ (level - 1),
//   then runs plain half-cleaners. The TPU rejected this form only
//   because Mosaic has no cheap reversal; here a mirror is an index.
// * Run-sums walk back at most s - 1 positions from each run end, the
//   window the plain scorer (ops/packed.py rank_candidates) sums over.
// * Top-k keeps a sorted top-16 per thread in registers during one
//   scan of the region, then takes k rounds of a block-wide maximum
//   over the threads' heads: one pass over the region instead of k.
//
// Bound on this card: the merge is shared-memory (or, for regions over
// kSmemRegionBytes, L2/HBM) bandwidth and __syncthreads latency:
// (log2(C/128) levels, sum of log2(level) passes) over C/2 pairs.
#pragma once

#include <cstdint>

namespace dse {

constexpr int kLanes = 128;  // one plane row; every stored run is one row
constexpr int kMaxK = 16;    // top-k held in registers per thread

__device__ __forceinline__ int key_doc(unsigned long long e, int kb) {
  return static_cast<int>(static_cast<unsigned>(e >> 32) >> kb);
}

__device__ __forceinline__ void cmp_swap(unsigned long long* a, int i,
                                         int j) {
  const unsigned long long x = a[i];
  const unsigned long long y = a[j];
  if (x > y) {
    a[i] = y;
    a[j] = x;
  }
}

// Sorts a[0, c) ascending in place; c is a power of two and a is made of
// ascending runs of `run` elements (run a power of two, run <= c).
template <int THREADS>
__device__ void merge_sorted_runs(unsigned long long* a, int c, int run) {
  const int pairs = c >> 1;
  for (int level = run << 1; level <= c; level <<= 1) {
    const int half = level >> 1;
    // mirror step: both halves of each level-window are ascending;
    // i in the low half meets i ^ (level - 1), its mirror in the high
    for (int p = threadIdx.x; p < pairs; p += THREADS) {
      const int i = ((p & ~(half - 1)) << 1) | (p & (half - 1));
      cmp_swap(a, i, i ^ (level - 1));
    }
    __syncthreads();
    for (int st = level >> 2; st >= 1; st >>= 1) {
      for (int p = threadIdx.x; p < pairs; p += THREADS) {
        const int i = ((p & ~(st - 1)) << 1) | (p & (st - 1));
        cmp_swap(a, i, i + st);
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long x,
                                                     unsigned long long y) {
  return x > y ? x : y;
}

// Top-k (k <= kMaxK) of the sorted region a[0, c): candidates are run
// ends with doc < n_docs and run-sum > 0. Writes vals_out[0, k) and
// docs_out[0, k) (local doc ids), (-1, -1) past the last candidate.
template <int THREADS>
__device__ void block_topk(const unsigned long long* a, int c, int s, int k,
                           int n_docs, int kb, int* vals_out,
                           int* docs_out) {
  __shared__ unsigned long long red[THREADS / 32];
  __shared__ unsigned long long winner;
  // composite (run << 32) | (0x7fffffff - doc): larger is better-ranked,
  // and unique, because a doc has one run end; 0 means "none"
  unsigned long long loc[kMaxK];
#pragma unroll
  for (int t = 0; t < kMaxK; ++t) loc[t] = 0ull;
  for (int i = threadIdx.x; i < c; i += THREADS) {
    const unsigned long long e = a[i];
    const int doc = key_doc(e, kb);
    if (doc >= n_docs) continue;
    if (i + 1 < c && key_doc(a[i + 1], kb) == doc) continue;  // not a run end
    int run = static_cast<int>(static_cast<unsigned>(e));
    for (int j = 1; j < s && j <= i; ++j) {
      const unsigned long long e2 = a[i - j];
      if (key_doc(e2, kb) != doc) break;
      run += static_cast<int>(static_cast<unsigned>(e2));
    }
    if (run <= 0) continue;
    const unsigned long long comp =
        (static_cast<unsigned long long>(static_cast<unsigned>(run)) << 32) |
        static_cast<unsigned>(0x7fffffff - doc);
    if (comp > loc[kMaxK - 1]) {
      loc[kMaxK - 1] = comp;
#pragma unroll
      for (int t = kMaxK - 1; t > 0; --t) {
        if (loc[t] > loc[t - 1]) {
          const unsigned long long tmp = loc[t];
          loc[t] = loc[t - 1];
          loc[t - 1] = tmp;
        }
      }
    }
  }
  for (int t = 0; t < k; ++t) {
    unsigned long long v = loc[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = umax64(v, __shfl_xor_sync(0xffffffffu, v, off));
    }
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x < 32) {
      unsigned long long w = threadIdx.x < THREADS / 32 ? red[threadIdx.x] : 0ull;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        w = umax64(w, __shfl_xor_sync(0xffffffffu, w, off));
      }
      if (threadIdx.x == 0) winner = w;
    }
    __syncthreads();
    const unsigned long long w = winner;
    if (w == 0ull) {  // exhausted: the same w in every thread
      if (threadIdx.x == 0) {
        for (int tt = t; tt < k; ++tt) {
          vals_out[tt] = -1;
          docs_out[tt] = -1;
        }
      }
      break;
    }
    if (threadIdx.x == 0) {
      vals_out[t] = static_cast<int>(w >> 32);
      docs_out[t] = 0x7fffffff - static_cast<int>(static_cast<unsigned>(w));
    }
    if (loc[0] == w) {  // the one owner pops its head
#pragma unroll
      for (int j = 0; j < kMaxK - 1; ++j) loc[j] = loc[j + 1];
      loc[kMaxK - 1] = 0ull;
    }
  }
}

}  // namespace dse
