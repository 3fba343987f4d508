// Fused search step on Hopper: postings pack + fixed-point scoring +
// merge + run-sums + top-k, one thread block per query.
//
// Replaces the TPU kernel document_search_engine_tpu/ops/fused_pallas.py
// _fused_kernel (lines 288-446, launched by fused_search_pallas at
// :464-592) together with its rank stage (rank.cuh): block_topk for
// k <= 16, block_topk_large for 16 < k <= 128, chosen by the template
// parameter kLargeK, so the k <= 16 instantiations carry none of the
// large-k code (nor its registers). The template parameter kLoad picks
// the load stage:
//
//   Load::kPlanes  the (X, 128) doc and value planes (the main path);
//   Load::kDlim    the same planes plus per-query doc limits [d_lo, d_hi)
//                  (doc-range splitting: the has_dlim branch of
//                  _fused_kernel, fused_pallas.py:395-427);
//   Load::kDv      one interleaved (X + 8, 256) doc|value plane, row r's
//                  docs in lanes [0, 128) and its values in [128, 256)
//                  (replaces ops/fused_dv.py _fused_dv_kernel, :119-240).
//
// What it computes, per query q and per plan block j (tables from
// ops/fused.py expand_plan_tables, each (nq, 1, n_blocks) int32):
//
//   srcrow  first plane row of the block, -1 = skipped block
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
// (doc << kb) | slot (kb > 0) or doc (kb == 0); lanes past a block's rem
// are not candidates and are not stored.
//
// Doc limits (kDlim): a posting inside the block (lane < rem) whose doc
// lies outside [d_lo, d_hi) keeps its TRUE key and gets ci 0. A piece's
// first row starts at the 128-aligned floor of its range, so it holds
// docs below d_lo in front of in-range ones: giving those a largest key
// would break the ascending order within the block that the merge
// relies on. A doc is wholly
// inside or outside the range, so an out-of-range doc's run-sum is 0 and
// the rank stage's run > 0 gate drops it.
//
// The dv layout (kDv) reads the same rows with the same 16-byte loads,
// from two places of one plane. The TPU kernel's 8-row aligned overhang
// (ALIGN_ROWS, a Mosaic DMA rule) has no counterpart here; the plane
// keeps its 8 zero pad rows so that it is the reference's bit for bit.
// The wrapper passes key_bits_for(s, n_docs) as for the two planes; the
// TPU dv kernel ranks raw docs (kb = 0), and the outputs are the same.
//
// What differs from the TPU kernel, and why:
// * Real postings only are stored, each block's behind the previous
//   block's (dstrow gives the slot id only; its row offsets, the TPU's
//   128-row compaction, are not used). The TPU stored whole sentinel-
//   padded rows because its merge network needs a power-of-two region of
//   full rows; the merge here (rank.cuh) takes runs of any length, so no
//   sentinel is written, merged or scanned. The postings of one slot are
//   consecutive blocks of one doc-sorted row, so a query's region is at
//   most s natural runs: rank.cuh finds them from the block offsets
//   recorded here and merges them in ceil(log2(s)) levels.
// * The region's two merge buffers live in dynamic shared memory when
//   the query's real postings fit twice (or once, with the second buffer
//   in the workspace), else in a per-query slice of a global workspace
//   that the wrapper allocates for buckets of r_c >= 128 rows. The
//   kernel decides per query, from the count of its real postings. The
//   TPU's 2048-row VMEM buffer is ~16x what one block's 227 KB of shared
//   memory holds.
// * Plane rows are read with 16-byte loads, only the rows that hold
//   real postings.
//
// Bound on this card: the latency of the load stage (one block after
// another, a few 16-byte loads in flight per thread) and of the serial
// merges in shared memory; the postings bytes are ~1% of HBM bandwidth.
#include <cuda_runtime.h>

#include "rank.cuh"

namespace dse {

constexpr int kSlotShift = 24;

enum class Load { kPlanes, kDlim, kDv };

template <bool kDlim>
__device__ __forceinline__ u64 make_candidate(int doc, int vbits, float a,
                                              float scale, float clip, int kb,
                                              unsigned slot, int d_lo,
                                              int d_hi) {
  float ci_f = rintf(__fmul_rn(__fmul_rn(a, __int_as_float(vbits)), scale));
  ci_f = fminf(fmaxf(ci_f, 0.0f), clip);
  unsigned ci = static_cast<unsigned>(static_cast<int>(ci_f));
  if constexpr (kDlim) {
    if (doc < d_lo || doc >= d_hi) ci = 0u;  // true key, no contribution
  }
  const unsigned key =
      kb ? ((static_cast<unsigned>(doc) << kb) | slot) : static_cast<unsigned>(doc);
  return (static_cast<u64>(key) << 32) | ci;
}

// post_doc is the doc plane, or the dv plane under Load::kDv (post_val
// is then unused); dlim is (nq, 1, 2) int32 under Load::kDlim, else
// unused. smem_bytes is the launch's dynamic shared memory: the run
// table (n_blocks + 1 offsets), then the merge buffers.
template <bool kLargeK, Load kLoad>
__global__ void __launch_bounds__(kThreads)
    fused_search_kernel(const int* __restrict__ post_doc,
                        const int* __restrict__ post_val,
                        const int* __restrict__ srcrow,
                        const int* __restrict__ rem,
                        const int* __restrict__ abits,
                        const int* __restrict__ dstrow,
                        const int* __restrict__ dlim, int n_blocks,
                        int block, int s, int k, int n_docs, float scale,
                        float clip, int r_c, int kb, int smem_bytes,
                        u64* __restrict__ workspace, int* __restrict__ vals,
                        int* __restrict__ docs) {
  constexpr bool kHasDlim = kLoad == Load::kDlim;
  extern __shared__ u64 smem_dyn[];
  const int q = blockIdx.x;
  const int c = r_c * kLanes;
  // at most min(n_blocks, c) blocks hold a posting
  const int table_words = (min(n_blocks, c) + 2) / 2;
  int* off = reinterpret_cast<int*>(smem_dyn);
  int d_lo = 0, d_hi = 0;
  if constexpr (kHasDlim) {
    d_lo = dlim[2 * static_cast<size_t>(q)];
    d_hi = dlim[2 * static_cast<size_t>(q) + 1];
  }
  const size_t plan = static_cast<size_t>(q) * n_blocks;
  // the query's real postings: every thread adds up the same blocks
  // (the planner sizes r_c to hold them all; never store past it)
  int n = 0;
  for (int j = 0; j < n_blocks; ++j) {
    if (srcrow[plan + j] < 0) continue;  // skipped block
    n += min(min(max(rem[plan + j], 0), block), c - n);
  }
  u64* a;
  u64* b;
  place_buffers(smem_dyn + table_words, smem_bytes / 8 - table_words,
                workspace == nullptr
                    ? nullptr
                    : workspace + static_cast<size_t>(q) * 2 * c,
                c, n, &a, &b);

  // load stage: each block's real postings behind the previous block's,
  // and the offset where each non-empty block begins
  int at = 0, units = 0;
  for (int j = 0; j < n_blocks; ++j) {
    const int src = srcrow[plan + j];
    if (src < 0) continue;
    const int valid = min(min(max(rem[plan + j], 0), block), c - at);
    if (valid <= 0) continue;
    const unsigned slot = static_cast<unsigned>(dstrow[plan + j]) >> kSlotShift;
    const float coeff = __int_as_float(abits[plan + j]);
    if (threadIdx.x == 0) off[units] = at;
    u64* out = a + at;
    const int n4 = (valid + 3) / 4;
    for (int e4 = threadIdx.x; e4 < n4; e4 += kThreads) {
      int4 dd, vv;
      if constexpr (kLoad == Load::kDv) {
        // row src + r of the dv plane: 64 int4 words, docs then values
        const int4* row = reinterpret_cast<const int4*>(
            post_doc + static_cast<size_t>(src + (e4 >> 5)) * (2 * kLanes));
        dd = __ldg(row + (e4 & 31));
        vv = __ldg(row + 32 + (e4 & 31));
      } else {
        const size_t base = static_cast<size_t>(src) * (kLanes / 4);
        dd = __ldg(reinterpret_cast<const int4*>(post_doc) + base + e4);
        vv = __ldg(reinterpret_cast<const int4*>(post_val) + base + e4);
      }
      const int e = e4 * 4;
      const int ds[4] = {dd.x, dd.y, dd.z, dd.w};
      const int vs[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (e + t < valid) {
          out[e + t] = make_candidate<kHasDlim>(ds[t], vs[t], coeff, scale,
                                                clip, kb, slot, d_lo, d_hi);
        }
      }
    }
    at += valid;
    ++units;
  }
  if (threadIdx.x == 0) off[units] = n;
  __syncthreads();
  const int n_runs = natural_runs<kThreads>(a, off, units, n);
  u64* sorted = merge_runs<kThreads>(a, b, off, n_runs, n);
  int* vals_q = vals + static_cast<size_t>(q) * k;
  int* docs_q = docs + static_cast<size_t>(q) * k;
  if constexpr (kLargeK) {
    block_topk_large<kThreads>(sorted, n, sorted == a ? b : a, s, k, n_docs,
                               kb, vals_q, docs_q);
  } else {
    block_topk<kThreads>(sorted, n, s, k, n_docs, kb, vals_q, docs_q);
  }
}

template <bool kLargeK, Load kLoad>
int launch_fused_search(const int* post_doc, const int* post_val,
                        const int* srcrow, const int* rem, const int* abits,
                        const int* dstrow, const int* dlim, int nq,
                        int n_blocks, int block, int s, int k, int n_docs,
                        float scale, float clip, int r_c, int key_bits,
                        u64* workspace, int* vals, int* docs,
                        cudaStream_t st) {
  const int c = r_c * kLanes;
  const int units = n_blocks < c ? n_blocks : c;
  const size_t want = table_bytes(units) + static_cast<size_t>(c) * 16;
  if (workspace == nullptr && want > static_cast<size_t>(kSmemMaxBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = region_smem_bytes(c, units);
  cudaError_t err = cudaFuncSetAttribute(
      fused_search_kernel<kLargeK, kLoad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMaxBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_search_kernel<kLargeK, kLoad><<<nq, kThreads, bytes, st>>>(
      post_doc, post_val, srcrow, rem, abits, dstrow, dlim, n_blocks, block,
      s, k, n_docs, scale, clip, r_c, key_bits, static_cast<int>(bytes),
      workspace, vals, docs);
  return static_cast<int>(cudaGetLastError());
}

template <Load kLoad>
int launch_any_k(const int* post_doc, const int* post_val, const int* srcrow,
                 const int* rem, const int* abits, const int* dstrow,
                 const int* dlim, int nq, int n_blocks, int block, int s,
                 int k, int n_docs, float scale, float clip, int r_c,
                 int key_bits, u64* workspace, int* vals,
                 int* docs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxLargeK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k <= kMaxK) {
    return launch_fused_search<false, kLoad>(
        post_doc, post_val, srcrow, rem, abits, dstrow, dlim, nq, n_blocks,
        block, s, k, n_docs, scale, clip, r_c, key_bits, workspace, vals,
        docs, st);
  }
  return launch_fused_search<true, kLoad>(
      post_doc, post_val, srcrow, rem, abits, dstrow, dlim, nq, n_blocks,
      block, s, k, n_docs, scale, clip, r_c, key_bits, workspace, vals, docs,
      st);
}

}  // namespace dse

extern "C" {

// Largest candidate region (r_c * 128 pairs * 8 bytes) that never needs a
// workspace; for larger ones the wrapper allocates nq * 2 * r_c * 128 * 8
// bytes, and the kernel uses a query's slice when its real pairs do not
// fit shared memory twice over.
int dse_smem_region_bytes() { return dse::kNoWorkspaceRegionBytes; }

// Most dynamic shared memory a launch asks for: the run table, then the
// merge buffers of the queries whose real pairs fit.
int dse_smem_max_bytes() { return dse::kSmemMaxBytes; }

const char* dse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream`; returns the launch's cudaError_t (0 = success).
// workspace == nullptr is allowed up to dse_smem_region_bytes; k > 16 selects
// the large-k rank stage (k <= 128); dlim == nullptr selects the load
// stage without doc limits.
int dse_fused_search(const int* post_doc, const int* post_val,
                     const int* srcrow, const int* rem, const int* abits,
                     const int* dstrow, const int* dlim, int nq,
                     int n_blocks, int block, int s, int k, int n_docs,
                     float scale, float clip, int r_c, int key_bits,
                     unsigned long long* workspace, int* vals, int* docs,
                     void* stream) {
  if (dlim == nullptr) {
    return dse::launch_any_k<dse::Load::kPlanes>(
        post_doc, post_val, srcrow, rem, abits, dstrow, nullptr, nq,
        n_blocks, block, s, k, n_docs, scale, clip, r_c, key_bits, workspace,
        vals, docs, stream);
  }
  return dse::launch_any_k<dse::Load::kDlim>(
      post_doc, post_val, srcrow, rem, abits, dstrow, dlim, nq, n_blocks,
      block, s, k, n_docs, scale, clip, r_c, key_bits, workspace, vals, docs,
      stream);
}

// The same over one interleaved (X + 8, 256) doc|value plane.
int dse_fused_search_dv(const int* post_dv, const int* srcrow,
                        const int* rem, const int* abits, const int* dstrow,
                        int nq, int n_blocks, int block, int s, int k,
                        int n_docs, float scale, float clip, int r_c,
                        int key_bits, unsigned long long* workspace,
                        int* vals, int* docs, void* stream) {
  return dse::launch_any_k<dse::Load::kDv>(
      post_dv, nullptr, srcrow, rem, abits, dstrow, nullptr, nq, n_blocks,
      block, s, k, n_docs, scale, clip, r_c, key_bits, workspace, vals, docs,
      stream);
}

}  // extern "C"
