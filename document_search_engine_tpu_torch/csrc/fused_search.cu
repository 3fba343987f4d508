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
// (doc << kb) | slot (kb > 0) or doc (kb == 0); masked lanes and every
// row no block writes hold the sentinel key n_docs << kb with ci 0.
//
// Doc limits (kDlim): a posting inside the block (lane < rem) whose doc
// lies outside [d_lo, d_hi) keeps its TRUE key and gets ci 0; only the
// rem tail gets the sentinel. A piece's first row starts at the
// 128-aligned floor of its range, so it holds docs below d_lo in front
// of in-range ones: turning those into the sentinel would break the
// ascending 128-run that merge_sorted_runs relies on. A doc is wholly
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

constexpr int kSlotShift = 24;
constexpr int kDstMask = (1 << kSlotShift) - 1;

enum class Load { kPlanes, kDlim, kDv };

template <bool kDlim>
__device__ __forceinline__ unsigned long long make_candidate(
    bool valid, int doc, int vbits, float a, float scale, float clip, int kb,
    unsigned slot, unsigned long long sentinel, int d_lo, int d_hi) {
  if (!valid) return sentinel;
  float ci_f = rintf(__fmul_rn(__fmul_rn(a, __int_as_float(vbits)), scale));
  ci_f = fminf(fmaxf(ci_f, 0.0f), clip);
  unsigned ci = static_cast<unsigned>(static_cast<int>(ci_f));
  if constexpr (kDlim) {
    if (doc < d_lo || doc >= d_hi) ci = 0u;  // true key, no contribution
  }
  const unsigned key =
      kb ? ((static_cast<unsigned>(doc) << kb) | slot) : static_cast<unsigned>(doc);
  return (static_cast<unsigned long long>(key) << 32) | ci;
}

// post_doc is the doc plane, or the dv plane under Load::kDv (post_val
// is then unused); dlim is (nq, 1, 2) int32 under Load::kDlim, else
// unused.
template <bool kSmem, bool kLargeK, Load kLoad>
__global__ void __launch_bounds__(kThreads)
    fused_search_kernel(const int* __restrict__ post_doc,
                        const int* __restrict__ post_val,
                        const int* __restrict__ srcrow,
                        const int* __restrict__ rem,
                        const int* __restrict__ abits,
                        const int* __restrict__ dstrow,
                        const int* __restrict__ dlim, int n_blocks,
                        int block, int s, int k, int n_docs, float scale,
                        float clip, int r_c, int kb,
                        unsigned long long* __restrict__ workspace,
                        int* __restrict__ vals, int* __restrict__ docs) {
  constexpr bool kHasDlim = kLoad == Load::kDlim;
  extern __shared__ unsigned long long smem_region[];
  const int q = blockIdx.x;
  const int c = r_c * kLanes;
  unsigned long long* region =
      kSmem ? smem_region : workspace + static_cast<size_t>(q) * c;
  const unsigned long long sentinel =
      static_cast<unsigned long long>(static_cast<unsigned>(n_docs) << kb)
      << 32;
  int d_lo = 0, d_hi = 0;
  if constexpr (kHasDlim) {
    d_lo = dlim[2 * static_cast<size_t>(q)];
    d_hi = dlim[2 * static_cast<size_t>(q) + 1];
  }
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
    unsigned long long* out = region + static_cast<size_t>(dst) * kLanes;
    const int n4 = nrows * (kLanes / 4);
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
      out[e + 0] = make_candidate<kHasDlim>(e + 0 < valid, dd.x, vv.x, a,
                                            scale, clip, kb, slot, sentinel,
                                            d_lo, d_hi);
      out[e + 1] = make_candidate<kHasDlim>(e + 1 < valid, dd.y, vv.y, a,
                                            scale, clip, kb, slot, sentinel,
                                            d_lo, d_hi);
      out[e + 2] = make_candidate<kHasDlim>(e + 2 < valid, dd.z, vv.z, a,
                                            scale, clip, kb, slot, sentinel,
                                            d_lo, d_hi);
      out[e + 3] = make_candidate<kHasDlim>(e + 3 < valid, dd.w, vv.w, a,
                                            scale, clip, kb, slot, sentinel,
                                            d_lo, d_hi);
    }
  }
  __syncthreads();
  merge_sorted_runs<kThreads>(region, c, kLanes);
  if constexpr (kLargeK) {
    block_topk_large<kThreads>(region, c, s, k, n_docs, kb,
                               vals + static_cast<size_t>(q) * k,
                               docs + static_cast<size_t>(q) * k);
  } else {
    block_topk<kThreads>(region, c, s, k, n_docs, kb,
                         vals + static_cast<size_t>(q) * k,
                         docs + static_cast<size_t>(q) * k);
  }
}

template <bool kLargeK, Load kLoad>
int launch_fused_search(const int* post_doc, const int* post_val,
                        const int* srcrow, const int* rem, const int* abits,
                        const int* dstrow, const int* dlim, int nq,
                        int n_blocks, int block, int s, int k, int n_docs,
                        float scale, float clip, int r_c, int key_bits,
                        unsigned long long* workspace, int* vals, int* docs,
                        cudaStream_t st) {
  if (workspace == nullptr) {
    const size_t bytes = static_cast<size_t>(r_c) * kLanes * 8;
    if (bytes > static_cast<size_t>(kSmemRegionBytes)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaFuncSetAttribute(
        fused_search_kernel<true, kLargeK, kLoad>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemRegionBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_search_kernel<true, kLargeK, kLoad><<<nq, kThreads, bytes, st>>>(
        post_doc, post_val, srcrow, rem, abits, dstrow, dlim, n_blocks,
        block, s, k, n_docs, scale, clip, r_c, key_bits, nullptr, vals, docs);
  } else {
    fused_search_kernel<false, kLargeK, kLoad><<<nq, kThreads, 0, st>>>(
        post_doc, post_val, srcrow, rem, abits, dstrow, dlim, n_blocks,
        block, s, k, n_docs, scale, clip, r_c, key_bits, workspace, vals,
        docs);
  }
  return static_cast<int>(cudaGetLastError());
}

template <Load kLoad>
int launch_any_k(const int* post_doc, const int* post_val, const int* srcrow,
                 const int* rem, const int* abits, const int* dstrow,
                 const int* dlim, int nq, int n_blocks, int block, int s,
                 int k, int n_docs, float scale, float clip, int r_c,
                 int key_bits, unsigned long long* workspace, int* vals,
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

// Largest candidate region (bytes) kept in shared memory; the wrapper
// allocates a workspace of nq * r_c * 128 * 8 bytes for larger ones.
int dse_smem_region_bytes() { return dse::kSmemRegionBytes; }

const char* dse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream`; returns the launch's cudaError_t (0 = success).
// workspace == nullptr selects the shared-memory region; k > 16 selects
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
