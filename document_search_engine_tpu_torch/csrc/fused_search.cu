// Fused search step on Hopper: postings pack + fixed-point scoring +
// merge + run-sums + top-k, one thread block per query.
//
// Replaces the TPU kernel document_search_engine_tpu/ops/fused_pallas.py
// _fused_kernel (lines 288-446, launched by fused_search_pallas at
// :464-592) together with its rank stage (rank.cuh). What it computes,
// per query q and per plan block j (tables from ops/fused.py
// expand_plan_tables, each (nq, 1, n_blocks) int32):
//
//   srcrow  first (X, 128) plane row of the block, -1 = skipped block
//   rem     postings left in the slot at the block's start (masks the
//           block's tail)
//   abits   the slot coefficient A_s as f32 bits
//   dstrow  the block's first row in q's compacted candidate region,
//           with the slot id in bits [24, 31)
//
// ci = clip(rne((A_s * val) * 2^bits), 0, clip) with round-to-nearest
// multiplies (__fmul_rn) and rintf (half to even, like jnp.round); the
// library is built with --fmad=false, so nothing is contracted into an
// FMA and the bits are the reference's. The candidate key is
// (doc << kb) | slot (kb > 0) or doc (kb == 0); masked lanes and every
// row no block writes hold the sentinel key n_docs << kb with ci 0.
//
// What differs from the TPU kernel, and why:
// * Each block stores exactly ceil(valid / 128) rows. The TPU stored a
//   fixed block/128 rows and let the next store in grid order overwrite
//   the overhang; thread blocks here run in no fixed order, and one
//   query's blocks are walked by one thread block, so the overhang is
//   simply not written.
// * The region of r_c * 128 pairs (8 bytes each) lives in dynamic shared
//   memory when it fits kSmemRegionBytes; larger regions (up to
//   n_blocks * 32 rows for queries with head terms) run the same code
//   over a per-query slice of a global workspace the wrapper allocates.
//   The TPU's 2048-row VMEM buffer is ~16x what one block's 227 KB of
//   shared memory holds.
// * Plane rows are read with 16-byte loads, only the rows that hold
//   real postings.
//
// Bound on this card: the rank stage's merge passes (shared memory or
// L2 traffic and barrier latency), not the postings reads.
#include <cuda_runtime.h>

#include "rank.cuh"

namespace dse {

constexpr int kThreads = 512;
constexpr int kSlotShift = 24;
constexpr int kDstMask = (1 << kSlotShift) - 1;
// regions up to 16384 pairs (r_c <= 128 rows) stay in shared memory
constexpr int kSmemRegionBytes = 128 * 1024;

__device__ __forceinline__ unsigned long long make_candidate(
    bool valid, int doc, int vbits, float a, float scale, float clip, int kb,
    unsigned slot, unsigned long long sentinel) {
  if (!valid) return sentinel;
  float ci_f = rintf(__fmul_rn(__fmul_rn(a, __int_as_float(vbits)), scale));
  ci_f = fminf(fmaxf(ci_f, 0.0f), clip);
  const unsigned ci = static_cast<unsigned>(static_cast<int>(ci_f));
  const unsigned key =
      kb ? ((static_cast<unsigned>(doc) << kb) | slot) : static_cast<unsigned>(doc);
  return (static_cast<unsigned long long>(key) << 32) | ci;
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
    fused_search_kernel(const int* __restrict__ post_doc,
                        const int* __restrict__ post_val,
                        const int* __restrict__ srcrow,
                        const int* __restrict__ rem,
                        const int* __restrict__ abits,
                        const int* __restrict__ dstrow, int n_blocks,
                        int block, int s, int k, int n_docs, float scale,
                        float clip, int r_c, int kb,
                        unsigned long long* __restrict__ workspace,
                        int* __restrict__ vals, int* __restrict__ docs) {
  extern __shared__ unsigned long long smem_region[];
  const int q = blockIdx.x;
  const int c = r_c * kLanes;
  unsigned long long* region =
      kSmem ? smem_region : workspace + static_cast<size_t>(q) * c;
  const unsigned long long sentinel =
      static_cast<unsigned long long>(static_cast<unsigned>(n_docs) << kb)
      << 32;
  for (int i = threadIdx.x; i < c; i += kThreads) region[i] = sentinel;
  __syncthreads();

  const size_t plan = static_cast<size_t>(q) * n_blocks;
  for (int j = 0; j < n_blocks; ++j) {
    const int src = srcrow[plan + j];
    if (src < 0) continue;  // skipped block: no rows
    const int valid = min(max(rem[plan + j], 0), block);
    const int packed = dstrow[plan + j];
    const int dst = packed & kDstMask;
    const unsigned slot = static_cast<unsigned>(packed) >> kSlotShift;
    // the planner sizes r_c to hold every block; never store past it
    const int nrows = min((valid + kLanes - 1) / kLanes, max(r_c - dst, 0));
    const float a = __int_as_float(abits[plan + j]);
    const int4* d4 = reinterpret_cast<const int4*>(
        post_doc + static_cast<size_t>(src) * kLanes);
    const int4* v4 = reinterpret_cast<const int4*>(
        post_val + static_cast<size_t>(src) * kLanes);
    unsigned long long* out = region + static_cast<size_t>(dst) * kLanes;
    const int n4 = nrows * (kLanes / 4);
    for (int e4 = threadIdx.x; e4 < n4; e4 += kThreads) {
      const int4 dd = __ldg(d4 + e4);
      const int4 vv = __ldg(v4 + e4);
      const int e = e4 * 4;
      out[e + 0] = make_candidate(e + 0 < valid, dd.x, vv.x, a, scale, clip,
                                  kb, slot, sentinel);
      out[e + 1] = make_candidate(e + 1 < valid, dd.y, vv.y, a, scale, clip,
                                  kb, slot, sentinel);
      out[e + 2] = make_candidate(e + 2 < valid, dd.z, vv.z, a, scale, clip,
                                  kb, slot, sentinel);
      out[e + 3] = make_candidate(e + 3 < valid, dd.w, vv.w, a, scale, clip,
                                  kb, slot, sentinel);
    }
  }
  __syncthreads();
  merge_sorted_runs<kThreads>(region, c, kLanes);
  block_topk<kThreads>(region, c, s, k, n_docs, kb,
                       vals + static_cast<size_t>(q) * k,
                       docs + static_cast<size_t>(q) * k);
}

}  // namespace dse

extern "C" {

// Largest candidate region (bytes) kept in shared memory; the wrapper
// allocates a workspace of nq * r_c * 128 * 8 bytes for larger ones.
int dse_smem_region_bytes() { return dse::kSmemRegionBytes; }

const char* dse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream`; returns the launch's cudaError_t (0 = success).
// workspace == nullptr selects the shared-memory region.
int dse_fused_search(const int* post_doc, const int* post_val,
                     const int* srcrow, const int* rem, const int* abits,
                     const int* dstrow, int nq, int n_blocks, int block,
                     int s, int k, int n_docs, float scale, float clip,
                     int r_c, int key_bits, unsigned long long* workspace,
                     int* vals, int* docs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (workspace == nullptr) {
    const size_t bytes = static_cast<size_t>(r_c) * dse::kLanes * 8;
    if (bytes > static_cast<size_t>(dse::kSmemRegionBytes)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaFuncSetAttribute(
        dse::fused_search_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dse::kSmemRegionBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    dse::fused_search_kernel<true><<<nq, dse::kThreads, bytes, st>>>(
        post_doc, post_val, srcrow, rem, abits, dstrow, n_blocks, block, s,
        k, n_docs, scale, clip, r_c, key_bits, nullptr, vals, docs);
  } else {
    dse::fused_search_kernel<false><<<nq, dse::kThreads, 0, st>>>(
        post_doc, post_val, srcrow, rem, abits, dstrow, n_blocks, block, s,
        k, n_docs, scale, clip, r_c, key_bits, workspace, vals, docs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
