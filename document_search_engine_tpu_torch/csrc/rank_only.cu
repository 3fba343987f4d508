// Rank-only kernel on Hopper: the rank stage of the fused search kernel
// (rank.cuh) over an already packed, uncompacted candidate buffer, one
// thread block per query.
//
// Replaces the TPU kernel document_search_engine_tpu/ops/rank_pallas.py
// _rank_kernel (line 405, launched by rank_pallas at :417-472 and
// wrapped by rank_candidates_pallas at :475), which backs the xla_rank
// scorer mode: the plain PyTorch pack (ops/packed.py pack_tables), then
// this kernel instead of the plain sort-based rank.
//
// Input, per query q: C = R * 128 pairs of int32 (d_key, ci), C a power
// of two, laid out so that every aligned `run`-element stretch is
// ascending in d_key: a CSR row's postings are unique ascending docs and
// masked lanes carry the sentinel doc n_docs with ci 0. The TPU kernel
// merged all C pairs, padding included, with a bitonic network. Here:
//
// * The padding never enters the region. A run is ascending and the
//   sentinel is its largest doc, so a run's real pairs (doc < n_docs)
//   are a prefix, found by one binary search per run; on the serving
//   path about 59% of a batch's packed pairs are padding, and most
//   queries' real pairs then fit shared memory whatever C is. A prefix
//   sum of the lengths gives each run's offset in the compacted region,
//   and only the real prefixes are read, with 16-byte loads.
// * Each pair becomes the 64-bit word (doc << 32) | ci, with kb = 0, so
//   every run is also ascending as a word (the docs of a run are
//   unique). Packing ci above the doc would break that.
// * Consecutive runs of one query slot are consecutive stretches of one
//   doc-sorted row, so after compaction a query is at most s natural
//   runs: rank.cuh finds them (natural_runs) and merges them in
//   ceil(log2(s)) merge-path levels (merge_runs), whatever C / run is.
// * The two merge buffers are placed per query from its count of real
//   pairs (rank.cuh place_buffers): in dynamic shared memory, or in the
//   query's slice of a global workspace, which the wrapper allocates for
//   the buckets whose C could need one. block_topk (k <= 16) and
//   block_topk_large (k <= 128) then rank the merged pairs as in the
//   fused kernel.
//
// Bound on this card: latency, of the binary searches and the compacting
// loads from device memory and of the serial merges; the real pairs are
// read once.
#include <cuda_runtime.h>

#include "rank.cuh"

namespace dse {

__device__ __forceinline__ u64 pair_word(int doc, int ci) {
  return (static_cast<u64>(static_cast<unsigned>(doc)) << 32) |
         static_cast<unsigned>(ci);
}

// smem_bytes is the launch's dynamic shared memory: the run table
// (c / run + 1 offsets), then the merge buffers.
template <bool kLargeK>
__global__ void __launch_bounds__(kThreads)
    rank_kernel(const int* __restrict__ d_key, const int* __restrict__ ci,
                int c, int run, int s, int k, int n_docs, int smem_bytes,
                u64* __restrict__ workspace, int* __restrict__ vals,
                int* __restrict__ docs) {
  extern __shared__ u64 smem_dyn[];
  __shared__ int n_sh;
  const int q = blockIdx.x;
  const int units = c / run;
  const int table_words = (units + 2) / 2;
  int* off = reinterpret_cast<int*>(smem_dyn);
  const int* dq = d_key + static_cast<size_t>(q) * c;
  const int* cq = ci + static_cast<size_t>(q) * c;
  // each run's real length: the first position with doc >= n_docs
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int* r = dq + static_cast<size_t>(u) * run;
    int lo = 0, hi = run;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(r + mid) < n_docs) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    off[u + 1] = lo;
  }
  __syncthreads();
  // lengths -> offsets: warp 0, an inclusive scan of 32 lengths a step
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base < units; base += 32) {
      const int u = base + lane;
      int v = u < units ? off[u + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int got = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += got;
      }
      if (u < units) off[u + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) {
      off[0] = 0;
      n_sh = carry;
    }
  }
  __syncthreads();
  const int n = n_sh;
  u64* a;
  u64* b;
  place_buffers(smem_dyn + table_words, smem_bytes / 8 - table_words,
                workspace == nullptr
                    ? nullptr
                    : workspace + static_cast<size_t>(q) * 2 * c,
                c, n, &a, &b);
  // compacting load: the real prefix of every run, four pairs a step
  const int4* d4 = reinterpret_cast<const int4*>(dq);
  const int4* c4 = reinterpret_cast<const int4*>(cq);
  const int run4 = run / 4;
  for (int e4 = threadIdx.x; e4 < c / 4; e4 += kThreads) {
    const int u = e4 / run4;
    const int e = (e4 - u * run4) * 4;  // position in the run
    const int at = off[u];
    const int len = off[u + 1] - at;
    if (e >= len) continue;
    const int4 dd = __ldg(d4 + e4);
    const int4 cc = __ldg(c4 + e4);
    u64* out = a + at + e;
    out[0] = pair_word(dd.x, cc.x);
    if (e + 1 < len) out[1] = pair_word(dd.y, cc.y);
    if (e + 2 < len) out[2] = pair_word(dd.z, cc.z);
    if (e + 3 < len) out[3] = pair_word(dd.w, cc.w);
  }
  __syncthreads();
  const int n_runs = natural_runs<kThreads>(a, off, units, n);
  u64* sorted = merge_runs<kThreads>(a, b, off, n_runs, n);
  int* vals_q = vals + static_cast<size_t>(q) * k;
  int* docs_q = docs + static_cast<size_t>(q) * k;
  if constexpr (kLargeK) {
    block_topk_large<kThreads>(sorted, n, sorted == a ? b : a, s, k, n_docs,
                               0, vals_q, docs_q);
  } else {
    block_topk<kThreads>(sorted, n, s, k, n_docs, 0, vals_q, docs_q);
  }
}

template <bool kLargeK>
int launch_rank(const int* d_key, const int* ci, int nq, int c, int run,
                int s, int k, int n_docs, u64* workspace, int* vals,
                int* docs, cudaStream_t st) {
  const int units = c / run;
  const size_t want = table_bytes(units) + static_cast<size_t>(c) * 16;
  if (workspace == nullptr && want > static_cast<size_t>(kSmemMaxBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (table_bytes(units) > static_cast<size_t>(kSmemMaxBytes) / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = region_smem_bytes(c, units);
  cudaError_t err = cudaFuncSetAttribute(
      rank_kernel<kLargeK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemMaxBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  rank_kernel<kLargeK><<<nq, kThreads, bytes, st>>>(
      d_key, ci, c, run, s, k, n_docs, static_cast<int>(bytes), workspace,
      vals, docs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dse

extern "C" {

// Launches on `stream`; returns the launch's cudaError_t (0 = success).
// d_key, ci: (nq, c) int32; vals, docs: (nq, k) int32 (local docs);
// workspace == nullptr is allowed while c * 8 <= dse_smem_region_bytes,
// else it holds nq * 2 * c * 8 bytes.
int dse_rank(const int* d_key, const int* ci, int nq, int c, int run, int s,
             int k, int n_docs, unsigned long long* workspace, int* vals,
             int* docs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > dse::kMaxLargeK || c < dse::kLanes || (c & (c - 1)) ||
      run < dse::kLanes || (run & (run - 1)) || run > c) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k <= dse::kMaxK) {
    return dse::launch_rank<false>(d_key, ci, nq, c, run, s, k, n_docs,
                                   workspace, vals, docs, st);
  }
  return dse::launch_rank<true>(d_key, ci, nq, c, run, s, k, n_docs,
                                workspace, vals, docs, st);
}

}  // extern "C"
