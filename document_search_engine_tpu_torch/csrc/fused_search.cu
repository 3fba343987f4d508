// Fused search step on Hopper: postings pack + fixed-point scoring +
// merge + run-sums + top-k, one thread block per query.
//
// Replaces the TPU kernel document_search_engine_tpu/ops/fused_pallas.py
// _fused_kernel (line 288, pallas_call at :544, launched by
// fused_search_pallas at :464) together with its rank stage (rank.cuh:
// natural_runs, merge_runs, and block_topk_large, the radix select, for
// every k <= 128). The template parameter kLoad picks the load stage:
//
//   Load::kPlanes  the (X, 128) doc and value planes (the main path);
//   Load::kDlim    the same planes plus per-query doc limits [d_lo, d_hi)
//                  (doc-range splitting: the has_dlim branch of
//                  _fused_kernel, fused_pallas.py:395-427);
//   Load::kDv      one interleaved (X + 8, 256) doc|value plane, row r's
//                  docs in lanes [0, 128) and its values in [128, 256)
//                  (replaces ops/fused_dv.py _fused_dv_kernel, :119).
//
// THREADS, the block's thread count (256 or 1024), is a template
// parameter too: the wrapper (ops/fused.py launch_threads) sizes it to
// the bucket's region, so that small regions run several blocks an SM
// (r_c 16: 6, held by shared memory; r_c 32: 3) and large ones spread
// their merge over more threads (regions of 64 rows and more take 128
// KiB of shared memory or more: one block an SM).
//
// What it computes, per query q and per plan block j (tables from
// ops/fused.py expand_plan_tables, each (nq, 1, n_blocks) int32):
//
//   srcrow  first plane row of the block, -1 = skipped block
//   rem     postings left in the slot at the block's start (masks the
//           block's tail)
//   abits   the slot coefficient A_s as f32 bits
//   dstrow  the slot id in bits [24, 31) (its low bits, the TPU's
//           compacted row offsets, are not used)
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
// relies on. A doc is wholly inside or outside the range, so an
// out-of-range doc's run-sum is 0 and the rank stage's run > 0 gate
// drops it.
//
// The load stage, in two steps:
// 1. Plan table. Warp 0 reads the query's n_blocks entries of the four
//    tables with coalesced loads, 32 blocks a step, and keeps the blocks
//    that hold a posting ("units"): each one's valid count
//    min(max(rem, 0), block), cut where the region's c pairs end, its
//    offset in the region and in int4 words of one plane (exclusive warp
//    scans), its first row, coefficient and slot. They go to dynamic
//    shared memory in front of the merge buffers (plan_table_bytes),
//    behind one barrier; no thread re-reads a plan table from device
//    memory or adds up the blocks' counts itself.
// 2. All of the query's blocks in flight at once. Every thread walks a
//    flattened int4 index over all units (its g-th word: the unit u with
//    q4[u] <= g < q4[u + 1], lane g - q4[u]), reads a doc and a value
//    int4 from the planes (or from both halves of one dv row), and
//    writes the real postings as (key << 32) | ci at off[u] + e of the
//    merge buffer a: each unit behind the previous one, the region and
//    unit table the rank stage merges (rank.cuh natural_runs,
//    merge_runs). No unit waits for the one before it: a query of the
//    two small buckets (1,161 and 2,225 pairs on average) is one or two
//    int4 a thread and plane, issued together.
//
// Reads past a unit's valid count (to its int4 or its dv row) stay inside
// the plane: the builder's NNZ_SLICE_MARGIN covers a whole block, and the
// dv plane keeps the reference's 8 zero pad rows. The TPU dv kernel's
// 8-row aligned overhang (ALIGN_ROWS, a Mosaic DMA rule) has no
// counterpart here. The wrapper passes key_bits_for(s, n_docs) as for the
// two planes; the TPU dv kernel ranks raw docs (kb = 0), and the outputs
// are the same. A bulk async copy a block into shared memory (one a
// block over the dv plane, the layout's one contiguous range) and
// 16-byte cp.async copies were measured against this load and were no
// faster (PERF.md); the bulk copy also cost registers.
//
// What differs from the TPU kernel, and why:
// * Real postings only are stored, each unit's behind the previous
//   one's. The TPU stored whole sentinel-padded rows because its merge
//   network needs a power-of-two region of full rows; the merge here
//   takes runs of any length, so no sentinel is written, merged or
//   scanned.
// * The TPU kept DEPTH = 8 block DMAs in flight from a VMEM ring; here
//   every block of the query is in flight at once (a few KiB for most
//   queries), so the load costs one round trip to device memory, not
//   one a block.
// * The region's two merge buffers live in dynamic shared memory when
//   the query's real postings fit twice (or once, with the second buffer
//   in the workspace), else in a per-query slice of a global workspace
//   that the wrapper allocates for buckets of r_c >= 128 rows. The
//   TPU's 2048-row VMEM buffer is ~16x what one block's 227 KB of shared
//   memory holds.
//
// Bound on this card: the rank stage (the serial merge levels and the
// radix select's passes and barriers in shared memory, and for the few
// queries whose buffers lie in the workspace the sector traffic of their
// levels) and how many blocks an SM holds; the load stage is one round
// trip a query. The postings bytes are ~1% of HBM bandwidth, so the
// bytes bound (chip_smoke.py fused_bound) is far below the kernel's
// time.
#include <cuda_runtime.h>

#include "rank.cuh"

namespace dse {

constexpr int kSlotShift = 24;

enum class Load { kPlanes, kDlim, kDv };

// Blocks an SM that the registers of a THREADS-thread instantiation must
// allow: 6 of 256 threads (what shared memory allows at r_c 16), 1 of
// 1024.
constexpr int min_blocks(int threads) {
  return threads >= 1536 ? 1 : 1536 / threads;
}

// Bytes of the plan table for at most `units` units: off and q4
// (units + 1 entries each), src, coeff and slot (units each), int32,
// rounded to 16 so that the merge buffers behind it lie on 16 bytes.
__host__ __device__ inline int plan_table_bytes(int units) {
  return ((5 * units + 2) * 4 + 15) / 16 * 16;
}

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

__device__ __forceinline__ int warp_incl_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int got = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += got;
  }
  return v;
}

// The query's plan table, built by warp 0 (step 1 of the load stage).
// Writes the units' entries, off/q4[units] and *units_out, *n_out.
__device__ void scan_plan(const int* __restrict__ srcrow,
                          const int* __restrict__ rem,
                          const int* __restrict__ abits,
                          const int* __restrict__ dstrow, size_t plan,
                          int n_blocks, int block, int c, int* off, int* q4,
                          int* src_u, int* coeff_u, int* slot_u,
                          int* units_out, int* n_out) {
  const int lane = threadIdx.x;
  int raw = 0, units = 0, w4 = 0;
  for (int base = 0; base < n_blocks; base += 32) {
    const int j = base + lane;
    int src = -1, r = 0;
    if (j < n_blocks) {
      src = srcrow[plan + j];
      r = rem[plan + j];
    }
    const int v = src >= 0 ? min(max(r, 0), block) : 0;
    const int incl = warp_incl_sum(v);
    // cut where the region ends (the planner sizes r_c to hold them all)
    const int at = min(raw + incl - v, c);
    const int valid = min(raw + incl, c) - at;
    const int n4 = (valid + 3) / 4;
    const int incl4 = warp_incl_sum(n4);
    const bool live = valid > 0;
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (live) {
      const int u = units + __popc(mask & ((1u << lane) - 1u));
      off[u] = at;
      q4[u] = w4 + incl4 - n4;
      src_u[u] = src;
      coeff_u[u] = abits[plan + j];
      slot_u[u] = static_cast<int>(static_cast<unsigned>(dstrow[plan + j]) >>
                                   kSlotShift);
    }
    units += __popc(mask);
    raw += __shfl_sync(0xffffffffu, incl, 31);
    w4 += __shfl_sync(0xffffffffu, incl4, 31);
  }
  if (lane == 0) {
    const int n = min(raw, c);
    off[units] = n;
    q4[units] = w4;
    *units_out = units;
    *n_out = n;
  }
}

// post_doc is the doc plane, or the dv plane under Load::kDv (post_val
// is then unused); dlim is (nq, 1, 2) int32 under Load::kDlim, else
// unused. smem_bytes is the launch's dynamic shared memory: the plan
// table, then the merge buffers.
template <Load kLoad, int THREADS>
__global__ void __launch_bounds__(THREADS, min_blocks(THREADS))
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
  constexpr bool kDv = kLoad == Load::kDv;
  extern __shared__ __align__(16) u64 smem_dyn[];
  __shared__ int units_sh, n_sh;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int c = r_c * kLanes;
  // at most min(n_blocks, c) blocks hold a posting
  const int cap = min(n_blocks, c);
  int* off = reinterpret_cast<int*>(smem_dyn);
  int* q4 = off + cap + 1;
  int* src_u = q4 + cap + 1;
  int* coeff_u = src_u + cap;
  int* slot_u = coeff_u + cap;
  if (tid < 32) {
    scan_plan(srcrow, rem, abits, dstrow, static_cast<size_t>(q) * n_blocks,
              n_blocks, block, c, off, q4, src_u, coeff_u, slot_u,
              &units_sh, &n_sh);
  }
  __syncthreads();
  const int units = units_sh;
  const int n = n_sh;
  int d_lo = 0, d_hi = 0;
  if constexpr (kHasDlim) {
    d_lo = dlim[2 * static_cast<size_t>(q)];
    d_hi = dlim[2 * static_cast<size_t>(q) + 1];
  }
  const int table_words = plan_table_bytes(cap) / 8;
  u64* a;
  u64* b;
  place_buffers(smem_dyn + table_words, smem_bytes / 8 - table_words,
                workspace == nullptr
                    ? nullptr
                    : workspace + static_cast<size_t>(q) * 2 * c,
                c, n, &a, &b);
  // step 2: the flattened int4 index over all units
  const int n4 = q4[units];
  int u = 0;
  for (int g = tid; g < n4; g += THREADS) {
    while (q4[u + 1] <= g) ++u;
    const int e4 = g - q4[u];
    const size_t row = static_cast<size_t>(src_u[u]);
    int4 dd, vv;
    if constexpr (kDv) {
      // row src + e4 / 32 of the dv plane: 64 int4, docs then values
      const int4* p = reinterpret_cast<const int4*>(
          post_doc + (row + e4 / 32) * (2 * kLanes));
      dd = __ldg(p + e4 % 32);
      vv = __ldg(p + 32 + e4 % 32);
    } else {
      dd = __ldg(reinterpret_cast<const int4*>(post_doc) +
                 row * (kLanes / 4) + e4);
      vv = __ldg(reinterpret_cast<const int4*>(post_val) +
                 row * (kLanes / 4) + e4);
    }
    const int e = e4 * 4;
    const int valid = off[u + 1] - off[u];
    const float coeff = __int_as_float(coeff_u[u]);
    const unsigned slot = static_cast<unsigned>(slot_u[u]);
    u64* out = a + off[u];
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
  __syncthreads();
  const int n_runs = natural_runs<THREADS>(a, off, units, n);
  u64* sorted = merge_runs<THREADS>(a, b, off, n_runs, n);
  int* vals_q = vals + static_cast<size_t>(q) * k;
  int* docs_q = docs + static_cast<size_t>(q) * k;
  block_topk_large<THREADS>(sorted, n, sorted == a ? b : a, s, k, n_docs, kb,
                            vals_q, docs_q);
}

using FusedKernel = void (*)(const int*, const int*, const int*, const int*,
                             const int*, const int*, const int*, int, int,
                             int, int, int, float, float, int, int, int, u64*,
                             int*, int*);

// The instantiation for a thread count, nullptr for one the library was
// not built for.
template <Load kLoad>
FusedKernel kernel_for(int threads) {
  switch (threads) {
    case 256:
      return &fused_search_kernel<kLoad, 256>;
    case 1024:
      return &fused_search_kernel<kLoad, 1024>;
    default:
      return nullptr;
  }
}

inline FusedKernel kernel_for(Load load, int threads) {
  switch (load) {
    case Load::kPlanes:
      return kernel_for<Load::kPlanes>(threads);
    case Load::kDlim:
      return kernel_for<Load::kDlim>(threads);
    default:
      return kernel_for<Load::kDv>(threads);
  }
}

// Dynamic shared memory a launch over regions of c pairs in at most
// `units` units wants: the plan table and two buffers (asked for up to
// kSmemMaxBytes).
inline size_t fused_smem_want(int c, int units) {
  return static_cast<size_t>(plan_table_bytes(units)) +
         static_cast<size_t>(c) * 16;
}

inline int fused_smem_bytes(int c, int units) {
  const size_t want = fused_smem_want(c, units);
  return static_cast<int>(
      want < static_cast<size_t>(kSmemMaxBytes) ? want : kSmemMaxBytes);
}

int launch_fused(Load load, const int* post_doc, const int* post_val,
                 const int* srcrow, const int* rem, const int* abits,
                 const int* dstrow, const int* dlim, int nq, int n_blocks,
                 int block, int s, int k, int n_docs, float scale, float clip,
                 int r_c, int key_bits, int threads, u64* workspace,
                 int* vals, int* docs, void* stream) {
  if (k < 1 || k > kMaxLargeK) return static_cast<int>(cudaErrorInvalidValue);
  const FusedKernel kernel = kernel_for(load, threads);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int c = r_c * kLanes;
  const int units = n_blocks < c ? n_blocks : c;
  if (workspace == nullptr &&
      fused_smem_want(c, units) > static_cast<size_t>(kSmemMaxBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = fused_smem_bytes(c, units);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMaxBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nq, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      post_doc, post_val, srcrow, rem, abits, dstrow, dlim, n_blocks, block,
      s, k, n_docs, scale, clip, r_c, key_bits, bytes, workspace, vals, docs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dse

extern "C" {

// Largest candidate region (r_c * 128 pairs * 8 bytes) that never needs a
// workspace; for larger ones the wrapper allocates nq * 2 * r_c * 128 * 8
// bytes, and the kernel uses a query's slice when its real pairs do not
// fit shared memory twice over.
int dse_smem_region_bytes() { return dse::kNoWorkspaceRegionBytes; }

// Most dynamic shared memory a launch asks for: the run (or plan) table,
// then the merge buffers of the queries whose real pairs fit.
int dse_smem_max_bytes() { return dse::kSmemMaxBytes; }

const char* dse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream`; returns the launch's cudaError_t (0 = success).
// workspace == nullptr is allowed up to dse_smem_region_bytes; dlim ==
// nullptr selects the load stage without doc limits; k <= 128. threads
// is the block's thread count (ops/fused.py launch_threads): 256 or 1024,
// any other value is refused.
int dse_fused_search(const int* post_doc, const int* post_val,
                     const int* srcrow, const int* rem, const int* abits,
                     const int* dstrow, const int* dlim, int nq,
                     int n_blocks, int block, int s, int k, int n_docs,
                     float scale, float clip, int r_c, int key_bits,
                     int threads, unsigned long long* workspace, int* vals,
                     int* docs, void* stream) {
  return dse::launch_fused(
      dlim == nullptr ? dse::Load::kPlanes : dse::Load::kDlim, post_doc,
      post_val, srcrow, rem, abits, dstrow, dlim, nq, n_blocks, block, s, k,
      n_docs, scale, clip, r_c, key_bits, threads, workspace, vals, docs,
      stream);
}

// The same over one interleaved (X + 8, 256) doc|value plane.
int dse_fused_search_dv(const int* post_dv, const int* srcrow,
                        const int* rem, const int* abits, const int* dstrow,
                        int nq, int n_blocks, int block, int s, int k,
                        int n_docs, float scale, float clip, int r_c,
                        int key_bits, int threads,
                        unsigned long long* workspace, int* vals, int* docs,
                        void* stream) {
  return dse::launch_fused(dse::Load::kDv, post_dv, nullptr, srcrow, rem,
                           abits, dstrow, nullptr, nq, n_blocks, block, s, k,
                           n_docs, scale, clip, r_c, key_bits, threads,
                           workspace, vals, docs, stream);
}

// Resident blocks an SM of the instantiation for (load 0: planes, 1:
// dlim, 2: dv; threads) over regions of r_c rows in n_blocks blocks; -1
// for a thread count the library was not built for.
int dse_fused_blocks_per_sm(int load, int threads, int r_c, int n_blocks) {
  const dse::FusedKernel kernel =
      dse::kernel_for(static_cast<dse::Load>(load), threads);
  if (kernel == nullptr) return -1;
  const int c = r_c * dse::kLanes;
  const int bytes = dse::fused_smem_bytes(c, n_blocks < c ? n_blocks : c);
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dse::kSmemMaxBytes) != cudaSuccess) {
    return -1;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    bytes) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

}  // extern "C"
