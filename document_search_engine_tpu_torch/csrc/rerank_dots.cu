// Rerank dots on Hopper: candidate gather + exact int8 dot products.
//
// Replaces the TPU kernel document_search_engine_tpu/ops/rerank.py
// rerank_dots_pallas (_dots_kernel :135, call :162) together with the
// XLA row gather in front of it (gather_and_dot, :196-209). What it
// computes, for query q and candidate j:
//
//   g              = max(gids[q, j], 0)      (dead candidates read row 0)
//   dots[q, j]     = sum_e qemb[q, e] * emb[g, e]     (int8 x int8 -> int32)
//   cand_ssq[q, j] = ssq[g]
//
// Exact: |cell| <= 63 on both sides, so every dot is under 2^20, and
// __dp4a (four signed int8 products and an int32 add) is exact in
// integers. The TPU gathered the (nq, K, E) candidate rows into HBM with
// XLA and fed them to the MXU in f32; here each row is read by gid
// inside the kernel, so the gathered tensor never exists.
//
// Bound on this card: bytes. A 16,384-query batch at K 64, dim 256 over
// 1M docs reads 268 MB of candidate rows, of which ~92 MB are distinct:
// 0.0324 ms at 3.35 TB/s (chip_smoke.py dots_bound). Its 2 * dim int8
// operations a candidate (0.5 GOP a batch) take ~0.3 us at the int8
// peak, and no tensor core helps: each candidate row is used once.
//
// What the first design lost (0.224 ms a batch on an H100 80GB HBM3 at
// 700 W, PERF.md): one block of 8 warps a query, each warp walking its
// candidates one at a time: load the gid, then the row as 4-byte words,
// then a 5-step shuffle, then lane 0 gathers ssq[g]. Three dependent
// memory latencies a candidate, 8 candidates in series a warp, at most
// 256 B in flight a warp.
//
// This design: a block of kDotsThreads threads serves `qb` queries and a
// tile of each one's candidates (K 64 at dim 256: one query, all 64).
//   1. gids: the block's first threads read its candidates' gids,
//      consecutive threads on consecutive candidates (one coalesced
//      round trip), clamp them to >= 0 and keep them in shared memory.
//   2. rows: a group of `lanes` threads covers one candidate row, lane l
//      reading chunk l (and l + 32 i where a row has more than 32
//      chunks) of `vec` bytes. Each group holds kDotsSlots candidates,
//      so every thread issues its kDotsSlots row loads (16-byte
//      ld.global.nc.v4 where vec is 16), and each group's lane 0 its
//      kDotsSlots ssq[g] loads, before the first __dp4a: all of a
//      query's rows and norms in one wave (K 64, dim 256: 16 groups of
//      16 lanes, 4 rows each). The lane's slice of the query row comes
//      in the same wave, into registers.
//   3. reduce: log2(lanes) xor shuffles within the group (4 at dim 256).
//   4. write: lane 0 stages its dots and norms in shared memory, and the
//      block writes both outputs coalesced (a query's K are contiguous).
// Two memory round trips a block, where the first design had ~3 a
// candidate: 0.077-0.079 ms a batch on the same card (PERF.md), held
// back by the 268 MB of row reads, of which the L2 serves the repeats
// it still holds.
//
// The launch shape comes from the wrapper (ops/rerank.py dots_launch,
// whose plain mirror the CPU tests hold against the reference): vec 16
// where dim % 16 == 0 and the emb and qemb bases are 16-byte aligned,
// else vec 4 (any dim % 4 == 0, e.g. 100); lanes = min(32, the power of
// two at or above dim / vec), a template parameter (dim 64, 128, 256,
// 512 at vec 16: 4, 8, 16, 32 lanes, one chunk each; longer rows loop
// over 32-chunk rounds); qb the most queries (a power of two) whose
// tiles still hold all K candidates, with a grid y over tiles where K is
// larger (K 200 at dim 256: 4 tiles of 64). Candidates past K, queries
// past nq and lanes past the row's last chunk are masked.
//
// ptxas (-Xptxas -v, sm_90a, -O3 --fmad=false; CUDA 12.8): no
// instantiation spills. Registers, <vec, lanes>: <16, 16> (dim 256,
// the rerank path) 32, so 8 blocks of 256 threads share an SM; <16, 8>,
// <16, 4>, <16, 2> 32; <16, 32> 48; <16, 1> 38; <4, 32> 38; <4, 16> 31;
// <4, 8>, <4, 4>, <4, 2> 30; <4, 1> 32. Static shared memory 3 * 4 B a
// cell: 768 B at 16 lanes, 12,288 B at 1.
#include <cuda_runtime.h>

#include <cstdint>

namespace dse {

constexpr int kDotsThreads = 256;
constexpr int kDotsSlots = 4;  // candidates a lane group holds in flight

template <int V>
struct DotsVec;

template <>
struct DotsVec<16> {
  using T = int4;
  static __device__ __forceinline__ T zero() { return make_int4(0, 0, 0, 0); }
  static __device__ __forceinline__ int dot(T a, T b, int acc) {
    acc = __dp4a(a.x, b.x, acc);
    acc = __dp4a(a.y, b.y, acc);
    acc = __dp4a(a.z, b.z, acc);
    return __dp4a(a.w, b.w, acc);
  }
};

template <>
struct DotsVec<4> {
  using T = int;
  static __device__ __forceinline__ T zero() { return 0; }
  static __device__ __forceinline__ int dot(T a, T b, int acc) {
    return __dp4a(a, b, acc);
  }
};

template <int V, int G>
__global__ void __launch_bounds__(kDotsThreads)
    rerank_dots_kernel(const int8_t* __restrict__ emb,
                       const int* __restrict__ ssq,
                       const int8_t* __restrict__ qemb,
                       const int* __restrict__ gids, int nq, int kc, int dim,
                       int qb, int* __restrict__ dots,
                       int* __restrict__ cand_ssq) {
  using Vec = DotsVec<V>;
  using T = typename Vec::T;
  constexpr int kGroups = kDotsThreads / G;  // candidate rows a step
  constexpr int kCells = kGroups * kDotsSlots;  // = qb * tile
  __shared__ int s_gid[kCells];
  __shared__ int s_dot[kCells];
  __shared__ int s_ssq[kCells];
  const int per_q = kGroups / qb;  // groups a query
  const int tile = per_q * kDotsSlots;  // candidates a query and block
  const int q0 = blockIdx.x * qb;
  const int j0 = blockIdx.y * tile;

  // 1. the block's gids: cell t is query q0 + t / tile, candidate
  // j0 + t % tile
  for (int t = threadIdx.x; t < kCells; t += kDotsThreads) {
    const int q = q0 + t / tile;
    const int j = j0 + t % tile;
    if (q < nq && j < kc) {
      s_gid[t] = max(__ldg(gids + static_cast<size_t>(q) * kc + j), 0);
    }
  }
  __syncthreads();

  // 2. group grp holds cells qi * tile + jg + per_q * s, s < kDotsSlots
  const int lane = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const int qi = grp / per_q;
  const int q = q0 + qi;
  const int jg = grp % per_q;
  const int cell0 = qi * tile + jg;
  const int chunks = dim / V;
  const int rounds = G < 32 ? 1 : (chunks + G - 1) / G;
  const T* rows = reinterpret_cast<const T*>(emb);
  const T* qrow = reinterpret_cast<const T*>(qemb) +
                  static_cast<size_t>(q < nq ? q : 0) * chunks;
  bool live[kDotsSlots];
  int g[kDotsSlots], acc[kDotsSlots], sq[kDotsSlots];
#pragma unroll
  for (int s = 0; s < kDotsSlots; ++s) {
    live[s] = q < nq && j0 + jg + per_q * s < kc;
    g[s] = live[s] ? s_gid[cell0 + per_q * s] : 0;
    acc[s] = 0;
    sq[s] = 0;
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kDotsSlots; ++s) {
      if (live[s]) sq[s] = __ldg(ssq + g[s]);
    }
  }
  // rounds > 1 only at 32 lanes; unrolled, that instantiation spilled
#pragma unroll 1
  for (int i = 0; i < rounds; ++i) {
    const int c = lane + G * i;
    const bool c_ok = q < nq && c < chunks;
    const T qv = c_ok ? __ldg(qrow + c) : Vec::zero();
    T r[kDotsSlots];
#pragma unroll
    for (int s = 0; s < kDotsSlots; ++s) {
      r[s] = live[s] && c < chunks
                 ? __ldg(rows + static_cast<size_t>(g[s]) * chunks + c)
                 : Vec::zero();
    }
#pragma unroll
    for (int s = 0; s < kDotsSlots; ++s) acc[s] = Vec::dot(r[s], qv, acc[s]);
  }

  // 3. the group's sum, in every lane of it
#pragma unroll
  for (int s = 0; s < kDotsSlots; ++s) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], off);
    }
  }

  // 4. stage, then write coalesced
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kDotsSlots; ++s) {
      if (live[s]) {
        s_dot[cell0 + per_q * s] = acc[s];
        s_ssq[cell0 + per_q * s] = sq[s];
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kCells; t += kDotsThreads) {
    const int qq = q0 + t / tile;
    const int j = j0 + t % tile;
    if (qq < nq && j < kc) {
      const size_t o = static_cast<size_t>(qq) * kc + j;
      dots[o] = s_dot[t];
      cand_ssq[o] = s_ssq[t];
    }
  }
}

template <int V>
int launch_dots(int lanes, dim3 grid, cudaStream_t st, const int8_t* emb,
                const int* ssq, const int8_t* qemb, const int* gids, int nq,
                int kc, int dim, int qb, int* dots, int* cand_ssq) {
#define DSE_DOTS_CASE(G)                                                 \
  case G:                                                                \
    rerank_dots_kernel<V, G><<<grid, kDotsThreads, 0, st>>>(             \
        emb, ssq, qemb, gids, nq, kc, dim, qb, dots, cand_ssq);          \
    break;
  switch (lanes) {
    DSE_DOTS_CASE(1)
    DSE_DOTS_CASE(2)
    DSE_DOTS_CASE(4)
    DSE_DOTS_CASE(8)
    DSE_DOTS_CASE(16)
    DSE_DOTS_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DSE_DOTS_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dse

extern "C" {

// Launches on `stream`; returns the launch's cudaError_t (0 = success).
// vec, lanes and qb are ops/rerank.py dots_launch's: vec 4 or 16 bytes a
// load (dim a multiple of it, emb and qemb aligned to it), lanes the
// power of two min(32, >= dim / vec), qb a power of two of at most
// kDotsThreads / lanes queries a block. nq and kc must be > 0.
int dse_rerank_dots(const int8_t* emb, const int* ssq, const int8_t* qemb,
                    const int* gids, int nq, int kc, int dim, int vec,
                    int lanes, int qb, int* dots, int* cand_ssq,
                    void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if ((vec != 4 && vec != 16) || dim <= 0 || dim % vec != 0 || nq <= 0 ||
      kc <= 0) {
    return bad;
  }
  if (reinterpret_cast<uintptr_t>(emb) % vec != 0 ||
      reinterpret_cast<uintptr_t>(qemb) % vec != 0) {
    return bad;
  }
  const int chunks = dim / vec;
  int want = 1;
  while (want < chunks && want < 32) want <<= 1;
  const int groups = dse::kDotsThreads / lanes;
  if (lanes != want || qb <= 0 || (qb & (qb - 1)) != 0 || qb > groups) {
    return bad;
  }
  const int tile = groups / qb * dse::kDotsSlots;
  const dim3 grid((nq + qb - 1) / qb, (kc + tile - 1) / tile);
  if (grid.y > 65535) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 16) {
    return dse::launch_dots<16>(lanes, grid, st, emb, ssq, qemb, gids, nq, kc,
                                dim, qb, dots, cand_ssq);
  }
  return dse::launch_dots<4>(lanes, grid, st, emb, ssq, qemb, gids, nq, kc,
                             dim, qb, dots, cand_ssq);
}

}  // extern "C"
