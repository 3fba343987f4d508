// Tiled search step on Hopper: the heavy buckets' fixed-point scoring
// by doc-range tiles in a shared-memory accumulator, then top-k.
//
// Replaces no TPU kernel of its own: it serves the buckets whose regions
// are r_c >= ops/fused.py TILED_MIN_RC rows, which the fused kernel
// (fused_search.cu, the port of document_search_engine_tpu/ops/
// fused_pallas.py _fused_kernel) served by storing every posting as a
// 64-bit key, merging the query's runs and summing run ends. It computes
// what that kernel computes for such a bucket, from the same plan tables:
// (nq, k) vals and local docs ranked by (score desc, doc asc), (-1, -1)
// past the last candidate.
//
// Why a second kernel: a score is an integer sum of clipped fixed-point
// terms, exact in any order, so a doc's sum needs no sort, only an
// accumulator. The merge over the workspace read and wrote every pair
// of a heavy query through L2 three times, in serial two-pointer loops
// (PERF.md §5). Here a pair costs one load and one shared-memory atomic.
//
// tiled_score_kernel: block (q, chunk) owns query q's tiles [chunk * tpb,
// (chunk + 1) * tpb), a tile being the doc range [t * W, (t + 1) * W)
// (W = kTile, tpb = kTilesPerBlock).
//   1. Runs. Warp 0 scans the query's plan blocks (as fused_search.cu
//      scan_plan, with its cut at c = r_c * 128 pairs) and joins the
//      blocks that continue one another in the plane (the block before
//      is full, of the same slot and coefficient, and this one starts
//      where it ends): a run is a contiguous, doc-ascending stretch of
//      one slot's term row. Real plans have one run a live slot.
//   2. Bounds. For a stretch of tiles, every (tile edge, run) pair's
//      first posting with doc >= the edge, by a binary search on the
//      doc plane, one a thread; then each tile's int4 words over its
//      runs (exclusive warp scans). The edge past the last tile is
//      n_docs, so a doc >= n_docs is never read.
//   3. Accumulate. A tile's int4 words of the doc and value planes are
//      one flattened index over its runs (as the fused kernel's load
//      stage); each posting's ci (make_candidate's arithmetic: __fmul_rn
//      twice, rintf, the clip; the library is built with --fmad=false)
//      is atomicAdd-ed into acc[doc - t * W] when positive, and the doc
//      set in a bitmap the first time its sum turns positive (old == 0;
//      ci >= 0, so once a doc).
//   4. Consume. Each thread walks its bitmap words; a set doc's sum
//      gives the composite (sum << 32) | (0x7fffffff - doc) (rank.cuh
//      run_end_composite's order: score desc, doc asc, unique), which
//      joins the block's candidate buffer when above its threshold; the
//      doc's accumulator and bit are cleared once it is handled. So a
//      tile costs its postings and W / 32 bitmap words, not W, and a
//      tile with no posting costs nothing. A full buffer is cut to its
//      top k (rank.cuh radix_kth), whose k-th composite becomes the
//      threshold, and the docs that found no room are walked again;
//      no doc enters the buffer twice.
//   5. The chunk's top k composites (0 past the last) go to the
//      survivors' scratch (nq, chunks, k).
// tiled_merge_kernel: one block a query keeps the top k of its chunks'
// survivors and ranks them (rank.cuh emit_ranked). Tiles are
// doc-disjoint, so the top k of the union of per-chunk top-k lists is
// the query's.
//
// The grid is (query, chunk) with the query fastest, so the blocks
// resident at one time are many queries on the same chunk of docs: the
// postings of the head terms that they share are read from L2.
//
// Duplicate docs: a doc twice in a term row is added twice, as the
// dense scatter adds it. The fused kernel's run-sums walk at most s
// pairs back from a run end, so the two agree while no doc occurs more
// than s times in a query's pairs.
//
// Bound on this card: the shared-memory atomics and the barriers of
// each tile (two a tile the query has postings in), and the latency of
// each tile's loads and of the bounds' binary searches, hidden by the
// blocks an SM (shared memory: W * 4.125 bytes and the buffers).
#include <cuda_runtime.h>

#include "rank.cuh"

namespace dse {

constexpr int kTiledSlotShift = 24;  // ops/fused.py SLOT_SHIFT
// Candidate composites a tile block holds before it cuts them to k
// (> kMaxLargeK, so that a cut always frees room), and the merge's.
constexpr int kTiledBuf = 1024;
constexpr int kMergeBuf = 1024;
constexpr int kMergeThreads = 256;
// The tile block's threads (ops/tiled.py TILED_THREADS; 256 and 1024 were
// no faster on the benchmark's buckets, PERF.md §6)
constexpr int kTiledThreads = 512;
// A tile is W = 1 << kTileLog2 docs, and a block walks kTilesPerBlock
// of them (ops/tiled.py TILE_DOCS, TILES_PER_BLOCK; chosen by an A/B on
// the card, PERF.md §6).
constexpr int kTileLog2 = 14;
constexpr int kTile = 1 << kTileLog2;
constexpr int kTilesPerBlock = 32;
// of a block's 227 KB, room left for the statics (radix select, flags)
constexpr int kTiledMaxSmem = 220 * 1024;

__device__ __forceinline__ int warp_incl_sum_tiled(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int got = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += got;
  }
  return v;
}

// Words of the bounds table: (tiles + 1) first postings and tiles x
// (runs + 1) word offsets a stretch of tiles. Sized so that a real plan
// (runs <= s) takes kTilesPerBlock tiles a stretch and any plan (runs <=
// n_blocks) at least one.
__host__ __device__ inline int tiled_bound_words(int s, int n_blocks) {
  const int real = (kTilesPerBlock + 1) * (2 * s + 1);
  const int any = 2 * (2 * n_blocks + 1);
  return real > any ? real : any;
}

// Dynamic shared memory of a tile block: the candidate buffer, the
// accumulator and bitmap of W docs, the run table and the bounds.
__host__ __device__ inline int tiled_smem_bytes(int n_blocks, int s) {
  return kTiledBuf * 8 + kTile * 4 + kTile / 8 + (3 * n_blocks + 1) * 4 +
         tiled_bound_words(s, n_blocks) * 4;
}

__host__ __device__ inline int tiled_chunks(int n_docs) {
  const int tiles = (n_docs + kTile - 1) >> kTileLog2;
  const int chunks = (tiles + kTilesPerBlock - 1) / kTilesPerBlock;
  return chunks > 0 ? chunks : 1;
}

// The query's runs, by warp 0 (step 1): run r is the pairs
// [run_off[r], run_off[r + 1]) of the query, read from plane row
// run_row[r] on, with coefficient bits run_coeff[r]. Writes *runs_out.
__device__ void scan_runs(const int* __restrict__ srcrow,
                          const int* __restrict__ rem,
                          const int* __restrict__ abits,
                          const int* __restrict__ dstrow, size_t plan,
                          int n_blocks, int block, int c, int* run_row,
                          int* run_off, int* run_coeff, int* runs_out) {
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  int raw = 0, runs = 0;
  // the block before the step's first: src, valid pairs, slot, coeff
  int p_src = -1, p_valid = 0, p_slot = -1, p_ab = 0;
  for (int base = 0; base < n_blocks; base += 32) {
    const int j = base + lane;
    int src = -1, r = 0, ab = 0, slot = -1;
    if (j < n_blocks) {
      src = srcrow[plan + j];
      r = rem[plan + j];
      ab = abits[plan + j];
      slot = static_cast<int>(static_cast<unsigned>(dstrow[plan + j]) >>
                              kTiledSlotShift);
    }
    const int v = src >= 0 ? min(max(r, 0), block) : 0;
    const int incl = warp_incl_sum_tiled(v);
    // cut where the region ends, as the fused kernel cuts
    const int at = min(raw + incl - v, c);
    const int valid = min(raw + incl, c) - at;
    int b_src = __shfl_up_sync(0xffffffffu, src, 1);
    int b_valid = __shfl_up_sync(0xffffffffu, valid, 1);
    int b_slot = __shfl_up_sync(0xffffffffu, slot, 1);
    int b_ab = __shfl_up_sync(0xffffffffu, ab, 1);
    if (lane == 0) {
      b_src = p_src;
      b_valid = p_valid;
      b_slot = p_slot;
      b_ab = p_ab;
    }
    const bool cont = b_valid == block && b_src >= 0 &&
                      src == b_src + block / kLanes && slot == b_slot &&
                      ab == b_ab;
    const bool start = valid > 0 && !cont;
    const unsigned mask = __ballot_sync(0xffffffffu, start);
    if (start) {
      const int u = runs + __popc(mask & below);
      run_row[u] = src;
      run_off[u] = at;
      run_coeff[u] = ab;
    }
    runs += __popc(mask);
    raw += __shfl_sync(0xffffffffu, incl, 31);
    p_src = __shfl_sync(0xffffffffu, src, 31);
    p_valid = __shfl_sync(0xffffffffu, valid, 31);
    p_slot = __shfl_sync(0xffffffffu, slot, 31);
    p_ab = __shfl_sync(0xffffffffu, ab, 31);
  }
  if (lane == 0) {
    run_off[runs] = min(raw, c);
    *runs_out = runs;
  }
}

// First i in [0, n) with docs[i] >= edge (n when none).
__device__ __forceinline__ int first_at_or_above(const int* __restrict__ docs,
                                                 int n, long long edge) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<long long>(__ldg(docs + mid)) < edge) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
    tiled_score_kernel(const int* __restrict__ post_doc,
                       const int* __restrict__ post_val,
                       const int* __restrict__ srcrow,
                       const int* __restrict__ rem,
                       const int* __restrict__ abits,
                       const int* __restrict__ dstrow, int n_blocks,
                       int block, int k, int n_docs, float scale,
                       float clip, int r_c, int bound_words,
                       u64* __restrict__ surv) {
  extern __shared__ __align__(16) u64 smem_dyn[];
  __shared__ int runs_sh, count_sh, overflow_sh;
  __shared__ u64 thresh_sh;
  const int q = blockIdx.x;
  const int chunk = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  u64* buf = smem_dyn;
  int* acc = reinterpret_cast<int*>(buf + kTiledBuf);
  unsigned* bits = reinterpret_cast<unsigned*>(acc + kTile);
  int* run_row = reinterpret_cast<int*>(bits + kTile / 32);
  int* run_off = run_row + n_blocks;
  int* run_coeff = run_off + n_blocks + 1;
  int* bnd = run_coeff + n_blocks;

  for (int i = tid; i < kTile; i += THREADS) acc[i] = 0;
  for (int i = tid; i < kTile / 32; i += THREADS) bits[i] = 0u;
  if (tid == 0) {
    count_sh = 0;
    overflow_sh = 0;
    thresh_sh = 0ull;
  }
  if (tid < 32) {
    scan_runs(srcrow, rem, abits, dstrow,
              static_cast<size_t>(q) * n_blocks, n_blocks, block,
              r_c * kLanes, run_row, run_off, run_coeff, &runs_sh);
  }
  __syncthreads();
  const int runs = runs_sh;
  const int n_tiles = (n_docs + kTile - 1) >> kTileLog2;
  const int t0 = chunk * kTilesPerBlock;
  const int t1 = min(t0 + kTilesPerBlock, n_tiles);
  // tiles a stretch: the bounds table holds (tiles + 1) x runs first
  // postings and tiles x (runs + 1) word offsets
  const int stretch =
      runs > 0
          ? max(1, min(kTilesPerBlock, bound_words / (2 * runs + 1) - 1))
          : 1;
  int* first = bnd;
  int* q4_tab = bnd + (stretch + 1) * runs;
  for (int ta = t0; runs > 0 && ta < t1; ta += stretch) {
    const int nt = min(stretch, t1 - ta);
    // step 2: every edge's first posting in every run
    for (int i = tid; i < (nt + 1) * runs; i += THREADS) {
      const int e = i / runs;
      const int r = i - e * runs;
      const long long edge =
          min(static_cast<long long>(ta + e) << kTileLog2,
              static_cast<long long>(n_docs));
      first[i] = first_at_or_above(
          post_doc + static_cast<size_t>(run_row[r]) * kLanes,
          run_off[r + 1] - run_off[r], edge);
    }
    __syncthreads();
    // each tile's int4 words over its runs, a warp a tile
    for (int e = tid >> 5; e < nt; e += THREADS / 32) {
      int w4 = 0;
      for (int rb = 0; rb < runs; rb += 32) {
        const int r = rb + lane;
        int n4 = 0;
        if (r < runs) {
          const int lo = first[e * runs + r];
          const int hi = first[(e + 1) * runs + r];
          n4 = hi > lo ? (hi + 3) / 4 - lo / 4 : 0;
        }
        const int incl = warp_incl_sum_tiled(n4);
        if (r < runs) q4_tab[e * (runs + 1) + r] = w4 + incl - n4;
        w4 += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) q4_tab[e * (runs + 1) + runs] = w4;
    }
    __syncthreads();
    for (int e = 0; e < nt; ++e) {
      const int* q4 = q4_tab + e * (runs + 1);
      const int n4 = q4[runs];
      if (n4 == 0) continue;  // the same in every thread
      const int tbase = (ta + e) << kTileLog2;
      const int* lo_e = first + e * runs;
      const int* hi_e = lo_e + runs;
      // step 3: accumulate
      int r = 0;
      for (int g = tid; g < n4; g += THREADS) {
        while (q4[r + 1] <= g) ++r;
        const int lo = lo_e[r];
        const int hi = hi_e[r];
        const int p = (lo & ~3) + 4 * (g - q4[r]);
        const size_t at = static_cast<size_t>(run_row[r]) * kLanes + p;
        const int4 dd = __ldg(reinterpret_cast<const int4*>(post_doc + at));
        const int4 vv = __ldg(reinterpret_cast<const int4*>(post_val + at));
        const float a = __int_as_float(run_coeff[r]);
        const int ds[4] = {dd.x, dd.y, dd.z, dd.w};
        const int vs[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (p + t < lo || p + t >= hi) continue;
          float ci_f = rintf(
              __fmul_rn(__fmul_rn(a, __int_as_float(vs[t])), scale));
          ci_f = fminf(fmaxf(ci_f, 0.0f), clip);
          const int ci = static_cast<int>(ci_f);
          if (ci <= 0) continue;
          const int off = ds[t] - tbase;
          if (atomicAdd(acc + off, ci) == 0) {
            atomicOr(bits + (off >> 5), 1u << (off & 31));
          }
        }
      }
      __syncthreads();
      // step 4: consume, again after each cut of a full buffer
      for (;;) {
        const u64 thr = thresh_sh;
        for (int w = tid; w < kTile / 32; w += THREADS) {
          unsigned word = bits[w];
          if (word == 0u) continue;
          unsigned left = word;
          while (word) {
            const int b = __ffs(word) - 1;
            word &= word - 1u;
            const int off = w * 32 + b;
            const u64 comp =
                (static_cast<u64>(static_cast<unsigned>(acc[off])) << 32) |
                static_cast<unsigned>(0x7fffffff - (tbase + off));
            if (comp > thr) {
              const int at = atomicAdd(&count_sh, 1);
              if (at >= kTiledBuf) {
                overflow_sh = 1;  // no room: walked again after the cut
                continue;
              }
              buf[at] = comp;
            }
            acc[off] = 0;
            left &= ~(1u << b);
          }
          bits[w] = left;
        }
        __syncthreads();
        if (!overflow_sh) break;  // nothing writes it before a barrier
        const u64 kth = keep_top<THREADS>(buf, kTiledBuf, k);
        if (tid == 0) {
          count_sh = k;
          overflow_sh = 0;
          thresh_sh = kth;
        }
        __syncthreads();
      }
    }
  }
  // step 5: the chunk's top k
  int m = count_sh;
  if (m > k) {
    keep_top<THREADS>(buf, m, k);
    m = k;
  }
  u64* out = surv + (static_cast<size_t>(q) * gridDim.y + chunk) * k;
  for (int i = tid; i < k; i += THREADS) out[i] = i < m ? buf[i] : 0ull;
}

// The query's top k of its chunks' survivors (0 = none), ranked into
// vals and docs.
__global__ void __launch_bounds__(kMergeThreads)
    tiled_merge_kernel(const u64* __restrict__ surv, int n_chunks, int k,
                       int* __restrict__ vals, int* __restrict__ docs) {
  __shared__ u64 buf[kMergeBuf];
  __shared__ int count_sh;
  __shared__ u64 thresh_sh;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int total = n_chunks * k;
  const u64* in = surv + static_cast<size_t>(q) * total;
  if (tid == 0) {
    count_sh = 0;
    thresh_sh = 0ull;
  }
  __syncthreads();
  for (int base = 0; base < total; base += kMergeThreads) {
    const int cnt = count_sh;
    __syncthreads();  // read by all before this round's appends
    if (cnt + kMergeThreads > kMergeBuf) {  // the same in every thread
      const u64 kth = keep_top<kMergeThreads>(buf, cnt, k);
      if (tid == 0) {
        count_sh = k;
        thresh_sh = kth;
      }
      __syncthreads();
    }
    const int i = base + tid;
    const u64 v = i < total ? in[i] : 0ull;
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
  const u64 kth = m > k ? radix_kth<kMergeThreads>(buf, m, k) : 0ull;
  emit_ranked<kMergeThreads>(buf, m, k, kth,
                             vals + static_cast<size_t>(q) * k,
                             docs + static_cast<size_t>(q) * k);
}

}  // namespace dse

extern "C" {

// Dynamic shared memory of a tile block for (n_blocks, s); -1 past what
// a block may have.
int dse_tiled_smem_bytes(int n_blocks, int s) {
  const int bytes = dse::tiled_smem_bytes(n_blocks, s);
  return bytes <= dse::kTiledMaxSmem ? bytes : -1;
}

// Launches the tile kernel (grid (nq, chunks)) and the merge (grid nq)
// on `stream`; surv is scratch for nq x chunks x k composites, chunks =
// ceil(ceil(n_docs / W) / kTilesPerBlock) (at least 1). Returns the
// first launch error (0 = success).
int dse_tiled_search(const int* post_doc, const int* post_val,
                     const int* srcrow, const int* rem, const int* abits,
                     const int* dstrow, int nq, int n_blocks, int block,
                     int s, int k, int n_docs, float scale, float clip,
                     int r_c, unsigned long long* surv, int* vals, int* docs,
                     void* stream) {
  const int bytes = dse_tiled_smem_bytes(n_blocks, s);
  if (k < 1 || k > dse::kMaxLargeK || n_blocks < 1 || bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = &dse::tiled_score_kernel<dse::kTiledThreads>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = dse::tiled_chunks(n_docs);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(nq, chunks), dse::kTiledThreads, bytes, st>>>(
      post_doc, post_val, srcrow, rem, abits, dstrow, n_blocks, block, k,
      n_docs, scale, clip, r_c, dse::tiled_bound_words(s, n_blocks), surv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dse::tiled_merge_kernel<<<nq, dse::kMergeThreads, 0, st>>>(
      surv, chunks, k, vals, docs);
  return static_cast<int>(cudaGetLastError());
}

// Resident tile blocks an SM for (n_blocks, s); -1 for a shape the
// library does not launch.
int dse_tiled_blocks_per_sm(int n_blocks, int s) {
  const auto kernel = &dse::tiled_score_kernel<dse::kTiledThreads>;
  const int bytes = dse_tiled_smem_bytes(n_blocks, s);
  if (bytes < 0) return -1;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess) {
    return -1;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, dse::kTiledThreads, bytes) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

}  // extern "C"
