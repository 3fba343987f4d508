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
// masked lanes carry the sentinel doc n_docs with ci 0. Each pair becomes
// the 64-bit word (doc << 32) | ci, with kb = 0, so every run is also
// ascending as a word (the docs of a run are unique, the sentinel tail
// equal) and merge_sorted_runs applies unchanged. Packing ci above the
// doc would break that. The region lives in dynamic shared memory when
// C * 8 B fits kSmemRegionBytes, else in a per-query slice of a global
// workspace the wrapper allocates (uncompacted buffers of head-term
// queries hold hundreds of thousands of pairs). block_topk (k <= 16) and
// block_topk_large (k <= 128) then rank as in the fused kernel.
//
// Bound on this card: the merge passes over the region (shared memory,
// or L2/HBM for workspace regions) and their barriers; the input is read
// once with 16-byte loads.
#include <cuda_runtime.h>

#include "rank.cuh"

namespace dse {

__device__ __forceinline__ unsigned long long pair_word(int doc, int ci) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(doc)) << 32) |
         static_cast<unsigned>(ci);
}

template <bool kSmem, bool kLargeK>
__global__ void __launch_bounds__(kThreads)
    rank_kernel(const int* __restrict__ d_key, const int* __restrict__ ci,
                int c, int run, int s, int k, int n_docs,
                unsigned long long* __restrict__ workspace,
                int* __restrict__ vals, int* __restrict__ docs) {
  extern __shared__ unsigned long long smem_region[];
  const int q = blockIdx.x;
  unsigned long long* region =
      kSmem ? smem_region : workspace + static_cast<size_t>(q) * c;
  const int4* d4 =
      reinterpret_cast<const int4*>(d_key + static_cast<size_t>(q) * c);
  const int4* c4 =
      reinterpret_cast<const int4*>(ci + static_cast<size_t>(q) * c);
  for (int e4 = threadIdx.x; e4 < c / 4; e4 += kThreads) {
    const int4 dd = __ldg(d4 + e4);
    const int4 cc = __ldg(c4 + e4);
    const int e = e4 * 4;
    region[e + 0] = pair_word(dd.x, cc.x);
    region[e + 1] = pair_word(dd.y, cc.y);
    region[e + 2] = pair_word(dd.z, cc.z);
    region[e + 3] = pair_word(dd.w, cc.w);
  }
  __syncthreads();
  merge_sorted_runs<kThreads>(region, c, run);
  int* vals_q = vals + static_cast<size_t>(q) * k;
  int* docs_q = docs + static_cast<size_t>(q) * k;
  if constexpr (kLargeK) {
    block_topk_large<kThreads>(region, c, s, k, n_docs, 0, vals_q, docs_q);
  } else {
    block_topk<kThreads>(region, c, s, k, n_docs, 0, vals_q, docs_q);
  }
}

template <bool kLargeK>
int launch_rank(const int* d_key, const int* ci, int nq, int c, int run,
                int s, int k, int n_docs, unsigned long long* workspace,
                int* vals, int* docs, cudaStream_t st) {
  if (workspace == nullptr) {
    const size_t bytes = static_cast<size_t>(c) * 8;
    if (bytes > static_cast<size_t>(kSmemRegionBytes)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaFuncSetAttribute(
        rank_kernel<true, kLargeK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemRegionBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    rank_kernel<true, kLargeK><<<nq, kThreads, bytes, st>>>(
        d_key, ci, c, run, s, k, n_docs, nullptr, vals, docs);
  } else {
    rank_kernel<false, kLargeK><<<nq, kThreads, 0, st>>>(
        d_key, ci, c, run, s, k, n_docs, workspace, vals, docs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dse

extern "C" {

// Launches on `stream`; returns the launch's cudaError_t (0 = success).
// d_key, ci: (nq, c) int32; vals, docs: (nq, k) int32 (local docs);
// workspace == nullptr selects the shared-memory region
// (dse_smem_region_bytes), else it holds nq * c * 8 bytes.
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
