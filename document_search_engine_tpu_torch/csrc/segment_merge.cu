// Cross-segment merge on Hopper: each query's top k over the ranked top-k
// lists that the batch step computed for it in every segment.
//
// Replaces no TPU kernel: the JAX package merges segments on the host
// (engine.py _merge_ranked, an np.lexsort of the S x k candidates). Here
// the merge runs at the end of the batch step (engine/engine.py
// _batch_step), inside its CUDA graph, so a batch reads back (nq, 2k)
// words instead of every segment's (nq, 2k).
//
// Input: the step's stacked output, rows of [k vals | k gids] int32, and
// pos (nq, S): the stacked row holding query q's list in segment si, -1
// where the query is in none of that segment's buckets. Segments hold
// disjoint global doc ids, so each candidate's composite
// (v << 32) | (0x7fffffff - gid), v > 0, is unique, and its order is the
// answer's: score desc, gid asc (rank.cuh run_end_composite's order).
// Dead entries (v <= 0: past a list's last hit) take composite 0 and never
// enter.
//
// One block a query, as fused_tiled.cu tiled_merge_kernel merges a
// query's chunks: the block streams its S x k candidates, a round of
// kSegMergeThreads at a time, appending those above the running
// threshold to a shared buffer; a buffer that could overflow in the next
// round is cut to its top k (rank.cuh keep_top), whose k-th composite
// becomes the threshold. The survivors are ranked by rank.cuh radix_kth
// and emit_ranked, (-1, -1) past the last hit.
//
// Bound on this card: the bytes of the candidates read (S x 2k words a
// query, neighbouring threads on neighbouring words of a row) and the
// written answer; the selection works in shared memory. At the live
// index's shape (1,024 queries x 10 segments x k 100) that is 9 MB,
// ~3 us at 3.35 TB/s.
#include <cuda_runtime.h>

#include "rank.cuh"

namespace dse {

constexpr int kSegMergeThreads = 256;
// > kMaxLargeK + kSegMergeThreads: a cut always leaves room for a round
constexpr int kSegMergeBuf = 1024;

__global__ void __launch_bounds__(kSegMergeThreads)
    segment_merge_kernel(const int* __restrict__ stacked,
                         const int* __restrict__ pos, int n_seg, int k,
                         int* __restrict__ out) {
  __shared__ u64 buf[kSegMergeBuf];
  __shared__ int count_sh;
  __shared__ u64 thresh_sh;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int total = n_seg * k;
  const int* pos_q = pos + static_cast<size_t>(q) * n_seg;
  if (tid == 0) {
    count_sh = 0;
    thresh_sh = 0ull;
  }
  __syncthreads();
  for (int base = 0; base < total; base += kSegMergeThreads) {
    const int cnt = count_sh;
    __syncthreads();  // read by all before this round's appends
    if (cnt + kSegMergeThreads > kSegMergeBuf) {  // the same in every thread
      const u64 kth = keep_top<kSegMergeThreads>(buf, cnt, k);
      if (tid == 0) {
        count_sh = k;
        thresh_sh = kth;
      }
      __syncthreads();
    }
    const int i = base + tid;
    u64 v = 0ull;
    if (i < total) {
      const int si = i / k;
      const int j = i - si * k;
      const int row = __ldg(pos_q + si);
      if (row >= 0) {
        const int* r = stacked + static_cast<size_t>(row) * 2 * k;
        const int val = __ldg(r + j);
        if (val > 0) {
          v = (static_cast<u64>(static_cast<unsigned>(val)) << 32) |
              static_cast<unsigned>(0x7fffffff - __ldg(r + k + j));
        }
      }
    }
    const bool keep = v > thresh_sh;
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (mask) {
      int at = 0;
      if (lane == __ffs(mask) - 1) at = atomicAdd(&count_sh, __popc(mask));
      at = __shfl_sync(0xffffffffu, at, __ffs(mask) - 1);
      if (keep) buf[at + __popc(mask & ((1u << lane) - 1u))] = v;
    }
    __syncthreads();
  }
  const int m = count_sh;
  const u64 kth = m > k ? radix_kth<kSegMergeThreads>(buf, m, k) : 0ull;
  int* out_q = out + static_cast<size_t>(q) * 2 * k;
  emit_ranked<kSegMergeThreads>(buf, m, k, kth, out_q, out_q + k);
}

}  // namespace dse

extern "C" {

// Launches the merge (grid nq) on `stream`: stacked is (rows, 2k) int32,
// pos (nq, n_seg) int32 rows of it or -1, out (nq, 2k) int32 [vals |
// gids]. Returns the launch's cudaError_t (0 = success).
int dse_segment_merge(const int* stacked, const int* pos, int nq, int n_seg,
                      int k, int* out, void* stream) {
  if (k < 1 || k > dse::kMaxLargeK || n_seg < 1 || nq < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq == 0) return 0;
  dse::segment_merge_kernel<<<nq, dse::kSegMergeThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      stacked, pos, n_seg, k, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
