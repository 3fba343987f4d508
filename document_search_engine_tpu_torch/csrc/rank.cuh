// Rank stage of the search kernels: merge of a query's sorted candidate
// runs, segmented run-sums and top-k by (score desc, doc asc), for one
// query's candidate region held by one thread block.
//
// Replaces the TPU rank pipeline
// (document_search_engine_tpu/ops/rank_pallas.py merge_rank_body):
// its k <= 16 branch (lines 94-316) with block_topk and its k 17..128
// tournament branch (lines 318-402) with block_topk_large. What it
// computes is the same; how differs, because what is scarce differs:
//
// * Candidates are (key, ci) pairs packed into one 64-bit word,
//   key << 32 | ci, with key = (doc << kb) | slot (kb > 0) or doc
//   (kb == 0) and ci >= 0. A comparison moves the pair as one word, so
//   the TPU network's tie-consistency term is not needed, and kb == 0
//   (where equal docs from different slots do tie on the key) sorts by
//   (doc, ci), which groups equal docs just the same. Equal words are
//   identical, so any correct sort gives the same bits.
// * The merge follows the data, not a fixed network. The TPU merged with
//   a bitonic network because its vector unit has no data-dependent
//   addressing; per level that costs log2(level) passes over the whole
//   region, 38-108 passes and barriers for the regions served here.
//   This card's shared memory has random access, and the input is far
//   more sorted than a network can use: per query it is at most s (the
//   query's slots) long ascending stretches, because the postings of one
//   term are stored in doc order and the stages in front write them
//   one after another. So the load stages store real pairs only, back to
//   back (no sentinel padding enters the region), with a table of the
//   offsets where a stored unit (a plan block, a packed run) begins;
//   natural_runs() keeps the offsets where order really breaks
//   (a[i - 1] > a[i]); merge_runs() merges adjacent runs pairwise,
//   ceil(log2(runs)) levels, each thread producing a fixed stretch of a
//   level's output: a co-rank binary search on its diagonal (merge
//   path), then a serial two-pointer merge. One barrier a level; the
//   output goes to a second buffer (ping-pong).
// * Where the buffers live is decided per query from its real pairs
//   (place_buffers): both in dynamic shared memory when 2 n words fit,
//   the first there and the second in the query's slice of a global
//   workspace when only n fit, else both in the slice. A workspace
//   region is crossed once a level (about 3 times), not once a pass.
// * Run-sums walk back at most s - 1 positions from each run end, the
//   window the plain scorer (ops/packed.py rank_candidates) sums over.
// * block_topk (the rank-only kernel's k <= 16): a sorted top-16 per
//   thread in registers during one scan of the merged pairs, then k
//   rounds of a block-wide maximum.
// * block_topk_large (every k <= 128 of the fused kernel, k 17..128 of
//   the rank-only kernel): each run end's composite is computed once,
//   into the buffer the merge left free; a radix select (8 bits a pass)
//   finds the k-th largest composite, and the k survivors are ranked by
//   counting.
//   The cost is at most 8 passes over the candidates and ~30 barriers
//   whatever k is, not two block barriers a rank and region rescans, and
//   no register list: at k = 10 it is faster than block_topk on the
//   small regions, whose blocks it lets share an SM (PERF.md).
//
// Bound on this card: the serial merges, n / threads steps a level of
// 8-byte reads at scattered addresses (bank conflicts in shared memory,
// sector traffic through L2 for workspace buffers), and the load stage
// in front; not device-memory bandwidth, not barriers.
#pragma once

#include <cstdint>

namespace dse {

typedef unsigned long long u64;

constexpr int kLanes = 128;  // one plane row
constexpr int kMaxK = 16;    // top-k held in registers per thread
constexpr int kMaxLargeK = 128;
// The rank-only kernel's thread block (one query's region); the fused
// kernel takes its thread count as a template parameter.
constexpr int kThreads = 512;
// Dynamic shared memory a launch may ask for (the card gives a block
// 227 KB; the rest is the rank stage's static tables), and the largest
// region (pairs * 8 B, before compaction) that never needs a workspace:
// two buffers of it and its run table fit kSmemMaxBytes.
constexpr int kSmemMaxBytes = 224 * 1024;
constexpr int kNoWorkspaceRegionBytes = 100 * 1024;

__device__ __forceinline__ int key_doc(u64 e, int kb) {
  return static_cast<int>(static_cast<unsigned>(e >> 32) >> kb);
}

__device__ __forceinline__ u64 umax64(u64 x, u64 y) { return x > y ? x : y; }

// Bytes of dynamic shared memory for a region of at most c pairs whose
// run table has at most units + 1 entries: the table, then two buffers,
// capped at kSmemMaxBytes.
inline size_t table_bytes(int units) {
  return (static_cast<size_t>(units) + 1 + 1) / 2 * 8;  // int32, 8-aligned
}

inline size_t region_smem_bytes(int c, int units) {
  const size_t want = table_bytes(units) + static_cast<size_t>(c) * 16;
  return want < static_cast<size_t>(kSmemMaxBytes) ? want : kSmemMaxBytes;
}

// Places the two merge buffers of a query with n real pairs: smem holds
// smem_words words behind the run table, slice is the query's 2 * c
// words of workspace (nullptr when the launch has none: n then fits).
__device__ __forceinline__ void place_buffers(u64* smem, int smem_words,
                                              u64* slice, int c, int n,
                                              u64** a, u64** b) {
  if (2 * n <= smem_words) {
    *a = smem;
    *b = smem + n;
  } else if (n <= smem_words) {
    *a = smem;
    *b = slice;
  } else {
    *a = slice;
    *b = slice + c;
  }
}

// off[0, units] holds ascending offsets into a[0, n), off[units] == n:
// unit u is a[off[u], off[u + 1]), ascending within itself. Keeps, in
// place, the offsets of the non-empty units where order breaks
// (a[off - 1] > a[off]; the first non-empty unit always), followed by n.
// Returns the number of natural runs. Called by every thread; warp 0
// works, in chunks of 32 units (a chunk's writes land at or below its
// own reads). Ends with a barrier.
template <int THREADS>
__device__ int natural_runs(const u64* a, int* off, int units, int n) {
  __shared__ int n_runs_sh;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int cnt = 0;
    for (int base = 0; base < units; base += 32) {
      const int u = base + lane;
      int o = 0;
      bool start = false;
      if (u < units) {
        o = off[u];
        const bool nonempty = off[u + 1] > o;
        start = nonempty && (o == 0 || a[o - 1] > a[o]);
      }
      const unsigned mask = __ballot_sync(0xffffffffu, start);
      if (start) off[cnt + __popc(mask & ((1u << lane) - 1u))] = o;
      cnt += __popc(mask);
      __syncwarp();
    }
    if (lane == 0) {
      off[cnt] = n;
      n_runs_sh = cnt;
    }
  }
  __syncthreads();
  return n_runs_sh;
}

// Merge path: how many of the first diag outputs of merge(x[0, lx),
// y[0, ly)) come from x, ties taken from x first.
__device__ __forceinline__ int corank(const u64* x, int lx, const u64* y,
                                      int ly, int diag) {
  int lo = max(0, diag - ly);
  int hi = min(diag, lx);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[mid] <= y[diag - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Sorts a[0, n), made of the n_runs ascending runs a[off[r], off[r + 1]),
// by merging adjacent groups of w runs, w = 1, 2, 4, ..., from one buffer
// into the other. Thread t writes outputs [t * stretch, (t + 1) * stretch)
// of every level; stretch is odd, so that the threads of a warp fall into
// different shared-memory banks. Returns the buffer that holds the result
// (a or b). Ends with a barrier when it ran a level; the caller has
// synchronized after filling a and off.
template <int THREADS>
__device__ u64* merge_runs(u64* a, u64* b, const int* off, int n_runs,
                           int n) {
  const int stretch = ((n + THREADS - 1) / THREADS) | 1;
  const int p_begin = min(n, static_cast<int>(threadIdx.x) * stretch);
  const int p_end = min(n, p_begin + stretch);
  u64* src = a;
  u64* dst = b;
  for (int w = 1; w < n_runs; w <<= 1) {
    int p = p_begin;
    while (p < p_end) {
      // the group of 2 w runs that holds output p: the last multiple g of
      // 2 w with off[g] <= p (runs are non-empty, offsets strictly ascend)
      int lo = 0;
      int hi = (n_runs - 1) / (2 * w);
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (off[mid * 2 * w] <= p) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const int g = lo * 2 * w;
      const int gs = off[g];
      const int gm = off[min(g + w, n_runs)];
      const int ge = off[min(g + 2 * w, n_runs)];
      const u64* x = src + gs;
      const u64* y = src + gm;
      const int lx = gm - gs;
      const int ly = ge - gm;
      const int stop = min(p_end, ge);
      int i = corank(x, lx, y, ly, p - gs);
      int j = p - gs - i;
      u64 xv = i < lx ? x[i] : ~0ull;
      u64 yv = j < ly ? y[j] : ~0ull;
      for (; p < stop; ++p) {
        if (xv <= yv) {
          dst[p] = xv;
          ++i;
          xv = i < lx ? x[i] : ~0ull;
        } else {
          dst[p] = yv;
          ++j;
          yv = j < ly ? y[j] : ~0ull;
        }
      }
    }
    __syncthreads();
    u64* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// The composite (run << 32) | (0x7fffffff - doc) of position i of the
// sorted pairs a[0, n) when it is a candidate (a run end with
// doc < n_docs and run-sum > 0), else 0. Larger is better-ranked, and
// unique, because a doc has one run end.
__device__ __forceinline__ u64 run_end_composite(const u64* a, int n, int i,
                                                 int s, int n_docs, int kb) {
  const u64 e = a[i];
  const int doc = key_doc(e, kb);
  if (doc >= n_docs) return 0ull;
  if (i + 1 < n && key_doc(a[i + 1], kb) == doc) return 0ull;
  int run = static_cast<int>(static_cast<unsigned>(e));
  for (int j = 1; j < s && j <= i; ++j) {
    const u64 e2 = a[i - j];
    if (key_doc(e2, kb) != doc) break;
    run += static_cast<int>(static_cast<unsigned>(e2));
  }
  if (run <= 0) return 0ull;
  return (static_cast<u64>(static_cast<unsigned>(run)) << 32) |
         static_cast<unsigned>(0x7fffffff - doc);
}

// Top-k (k <= kMaxK) of the sorted pairs a[0, n): writes vals_out[0, k)
// and docs_out[0, k) (local doc ids), (-1, -1) past the last candidate.
template <int THREADS>
__device__ void block_topk(const u64* a, int n, int s, int k, int n_docs,
                           int kb, int* vals_out, int* docs_out) {
  __shared__ u64 red[THREADS / 32];
  __shared__ u64 winner;
  u64 loc[kMaxK];  // this thread's best composites, descending; 0 = none
#pragma unroll
  for (int t = 0; t < kMaxK; ++t) loc[t] = 0ull;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const u64 comp = run_end_composite(a, n, i, s, n_docs, kb);
    if (comp > loc[kMaxK - 1]) {
      loc[kMaxK - 1] = comp;
#pragma unroll
      for (int t = kMaxK - 1; t > 0; --t) {
        if (loc[t] > loc[t - 1]) {
          const u64 tmp = loc[t];
          loc[t] = loc[t - 1];
          loc[t - 1] = tmp;
        }
      }
    }
  }
  for (int t = 0; t < k; ++t) {
    u64 v = loc[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v = umax64(v, __shfl_xor_sync(0xffffffffu, v, o));
    }
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x < 32) {
      u64 w = threadIdx.x < THREADS / 32 ? red[threadIdx.x] : 0ull;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        w = umax64(w, __shfl_xor_sync(0xffffffffu, w, o));
      }
      if (threadIdx.x == 0) winner = w;
    }
    __syncthreads();
    const u64 w = winner;
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

// The k-th largest of the m > k unique composites comp[0, m), by radix
// select: up to 8 passes from the top byte down, each a 256-bin histogram
// of the composites that still match the digits fixed so far, ending
// early once every match of the chosen bin is wanted (the bin's floor is
// then the threshold). Exactly k composites are >= the result. Called by
// every thread; returns the same value in each.
template <int THREADS>
__device__ u64 radix_kth(const u64* comp, int m, int k) {
  __shared__ int hist[256];
  __shared__ u64 prefix_sh;
  __shared__ int need_sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  u64 prefix = 0ull;
  int need = k;  // the rank still sought among the matching composites
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += THREADS) hist[i] = 0;
    __syncthreads();
    const u64 fixed = shift == 56 ? 0ull : (~0ull << (shift + 8));
    for (int i = tid; i < m; i += THREADS) {
      const u64 v = comp[i];
      if ((v & fixed) == prefix) {
        atomicAdd(&hist[static_cast<int>(v >> shift) & 255], 1);
      }
    }
    __syncthreads();
    if (tid < 32) {
      // lane l owns bins [8 l, 8 l + 8); above = matches in higher bins
      int mine = 0;
#pragma unroll
      for (int t = 0; t < 8; ++t) mine += hist[lane * 8 + t];
      int incl = mine;  // suffix sum over lanes >= l
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int got = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += got;
      }
      int above = incl - mine;
      if (above < need && need <= incl) {  // exactly one lane
        int d = lane * 8 + 7;
        while (above + hist[d] < need) {
          above += hist[d];
          --d;
        }
        prefix_sh = prefix | (static_cast<u64>(d) << shift);
        // the whole bin is wanted: its floor is the threshold (0 ends)
        need_sh = need - above == hist[d] ? 0 : need - above;
      }
    }
    __syncthreads();
    prefix = prefix_sh;
    need = need_sh;
    if (need == 0) break;
  }
  return prefix;
}

// Gathers the composites of comp[0, m) that are >= kth into sel, in no
// order, and returns how many (min(m, k) for the kth of radix_kth, or 0
// with m <= k). Called by every thread; ends with a barrier.
template <int THREADS>
__device__ int gather_top(const u64* comp, int m, u64 kth, u64* sel) {
  __shared__ int sel_sh;
  if (threadIdx.x == 0) sel_sh = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += THREADS) {
    const u64 v = comp[i];
    if (v >= kth) sel[atomicAdd(&sel_sh, 1)] = v;
  }
  __syncthreads();
  return sel_sh;
}

// Writes the m unique composites comp[0, m) that are >= kth (kth from
// radix_kth, or 0 when m <= k) ranked into vals_out[0, k) and
// docs_out[0, k) as (score, local doc), (-1, -1) past the last: each
// survivor finds its rank by counting the larger ones.
template <int THREADS>
__device__ void emit_ranked(const u64* comp, int m, int k, u64 kth,
                            int* vals_out, int* docs_out) {
  __shared__ u64 sel[kMaxLargeK];
  const int found = gather_top<THREADS>(comp, m, kth, sel);  // min(m, k)
  for (int t = threadIdx.x; t < k; t += THREADS) {
    if (t < found) {
      const u64 v = sel[t];
      int rank = 0;
      for (int u = 0; u < found; ++u) rank += sel[u] > v;
      vals_out[rank] = static_cast<int>(v >> 32);
      docs_out[rank] = 0x7fffffff - static_cast<int>(static_cast<unsigned>(v));
    } else {
      vals_out[t] = -1;
      docs_out[t] = -1;
    }
  }
}

// Top-k (k <= kMaxLargeK) of the sorted pairs a[0, n); the same contract
// and outputs as block_topk. comp is scratch for n words (the buffer the
// merge left free). Replaces the tournament branch of the TPU pipeline
// (a row-wise bitonic sort of the candidates and log2(R) rounds):
//   1. every run end's composite, once, into comp (unordered: a
//      warp-aggregated counter hands out the places);
//   2. when there are more than k, the k-th largest composite by radix
//      select (radix_kth);
//   3. the composites at or above it (exactly k, they are unique) are
//      gathered, and each finds its rank by counting the larger ones
//      (emit_ranked).
template <int THREADS>
__device__ void block_topk_large(const u64* a, int n, u64* comp, int s, int k,
                                 int n_docs, int kb, int* vals_out,
                                 int* docs_out) {
  __shared__ int m_sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) m_sh = 0;
  __syncthreads();
  for (int base = 0; base < n; base += THREADS) {
    const int i = base + tid;
    const u64 v = i < n ? run_end_composite(a, n, i, s, n_docs, kb) : 0ull;
    const unsigned mask = __ballot_sync(0xffffffffu, v != 0ull);
    if (mask) {
      int at = 0;
      if (lane == __ffs(mask) - 1) at = atomicAdd(&m_sh, __popc(mask));
      at = __shfl_sync(0xffffffffu, at, __ffs(mask) - 1);
      if (v != 0ull) comp[at + __popc(mask & ((1u << lane) - 1u))] = v;
    }
  }
  __syncthreads();
  const int m = m_sh;
  // every composite is > 0: all of them when m <= k
  const u64 kth = m > k ? radix_kth<THREADS>(comp, m, k) : 0ull;
  emit_ranked<THREADS>(comp, m, k, kth, vals_out, docs_out);
}

// Cuts the unique composites buf[0, m), m > k, to their top k in
// buf[0, k) and returns the k-th. Called by every thread; ends with a
// barrier.
template <int THREADS>
__device__ u64 keep_top(u64* buf, int m, int k) {
  __shared__ u64 sel[kMaxLargeK];
  const u64 kth = radix_kth<THREADS>(buf, m, k);
  gather_top<THREADS>(buf, m, kth, sel);  // exactly k
  for (int i = threadIdx.x; i < k; i += THREADS) buf[i] = sel[i];
  __syncthreads();
  return kth;
}

}  // namespace dse
