#!/usr/bin/env python3
"""Smoke test of the torch port on one NVIDIA GPU: build -> search_stream,
the hybrid rerank path search_rerank, the xla_rank, fused_dv and
doc-range split serving paths, the index lifecycle (streaming build,
delete, compact, save/load, the CLI), the sharded engine
(DistributedSearchEngine over 1, 2, 4 and 8 shards on the one card),
the reference scorers, the entry points and the trace, the port's
benchmark (`python -m document_search_engine_tpu_torch bench`), and the
port's tools: the differential fuzz, the segment-count curve, the
host profile, the lever and batch-size A/Bs and the kernel's per-stage
roofline (phase tools).

    python3 chip_smoke.py            # the full run, one card, < 20 min

Phases, each of which fails the run (non-zero exit, no result line):

1. Card and build: requires CUDA, prints the card's name and power limit
   (nvidia-smi), builds the kernels from csrc/ with nvcc (one nvcc per
   source, in parallel).
2. Kernels against their plain versions, on the card. The fused kernel:
   seeded random plans covering shared-memory and global-workspace
   regions, k in {1, 10, 16} (the k <= 16 branch) and {17, 32, 64, 100,
   128} (the large-k branch), unique keys (kb > 0) and plain doc keys
   (kb = 0), missing slots, rem tails, skipped blocks, duplicate rows
   (ties), queries with fewer than k hits, winners crowded into one
   thread's positions, an empty segment and several buckets; its dv load
   stage on the same plans over the interleaved plane. Its doc-limit
   (dlim) load stage: doc-range pieces from the device quantile tables
   (first rows that start below d_lo, ranges with no docs), and
   arbitrary limits (empty, touching 0 and n_docs), both key widths and
   both region kinds; the merged pieces must also equal the unsplit
   plain scorer. The rank-only kernel: block-sorted rows of C 1,024 to
   131,072 pairs (shared memory and workspace), block {256, 1024}, k in
   {1, 10, 16, 17, 64, 128}, s in {1, 8, 32}, zero contributions, an
   empty query, a query with fewer than k hits, and crowded winners.
   Cases aimed at the rank stage's merge (natural runs, merge path), for
   all four (fused, dv, dlim, rank-only), every k of {1, 10, 16, 17, 64,
   128}, kb > 0 and kb = 0: a region that is one run; a break at every
   block or run boundary (blocks in reverse order; the worst case), in
   shared memory and in the workspace; one posting beside thousands; 3
   and 5 runs; blocks skipped and all-sentinel runs between real ones;
   equal docs in 8 runs; real pairs one under, at and one over each
   shared-memory capacity (both merge buffers, the first only); exactly
   k candidates and fewer; winners side by side in one warp's stretch.
   Cases aimed at the fused kernel's load stage (phase_load_fused), for
   fused, dv and dlim, every k of {1, 10, 16, 17, 64, 128}, kb > 0 and
   kb = 0, each structure at three sizes so that its queries' merge
   buffers lie in shared memory (both; the first only) and in the
   workspace: rem tails not a multiple of 4, blocks skipped between real ones,
   n_blocks 128, the last term's rows ending at the plane's last row (or
   the dv plane's pad rows), exactly c real pairs, doc-range pieces that
   start below d_lo, an empty query in each, and r_c on each side of each
   thread-count threshold (with queries that reach every placement at
   its larger sizes). The rerank dots: random int8 tables at dim {64,
   100, 256, 1024}, each with 16-byte and 4-byte loads (dim 100: 4-byte
   only), K in {1, 10, 16, 64, 65, 200}, 301 queries (a multiple of no
   queries a block above 1), with dead (-1) and repeated gids, a query
   with no live candidate and the table's last row. The segment merge
   (ops/segment_merge.py, phase_segment_merge): random ranked lists at
   the live index's batch (1,024 queries x 10 segments x k 100), at k
   10 and at four more shapes, with lists shorter than k, queries in no
   segment's buckets, junk rows between the lists and equal scores
   across segments; timed at the first two. Results must be
   bit-identical.
3. Parity on the card: SearchEngine(device="cuda") equals the frozen CPU
   oracle in ids and integer scores (bm25 and tfidf, k up to 200), in
   the default mode and in each of scorer "xla_rank", scorer "fused_dv"
   and split_rows 2 (every real query splits; three segments, one of
   them empty-vocabulary), and its search_rerank equals the same call
   on a device="cpu" engine built from the same docs (two segments, one
   of them empty-vocabulary).
4. The main path at full size: a 1,000,000-doc bm25 index (200k-term
   Zipf vocabulary, 40 tokens per doc on average) built through
   SearchEngine.build, then search_stream over 4 batches of 16,384
   raw-text queries (8 terms of df 64..32768 each), k=10, depth 2,
   through the engine's step graphs (engine/step_graph.py; warmup
   captured the batch's graph). The
   build's peak device bytes above its start must stay within the build
   rule: the resident index + 12 B x the triples' nnz_cap
   (builder.shape_bucket of the postings) + 512 MiB of chunk workspace;
   the segment is then built once more with the peak read around each
   stage (device_pack, device_align_planes, device_materialize_vals),
   and the log line prints the three. The
   kernel's launch count over that run must equal its buckets (one
   launch a bucket and batch, as the eager step counts them; the
   replays add each graph's captured counts), the graph pool's bytes
   after the serving passes may not exceed the graphs times the eager
   step's peak above its start on the last batch (the segments of a
   fresh memory pool it runs in), and per batch a
   seeded sample of >= 1,024 queries covering every bucket cell must
   equal the plain scorer on the card. Serving q/s is the median of 5
   more passes. One batch's buckets are then compared in full, kernel
   against plain version, and timed as the median of 5 warm runs: all
   together, and each bucket alone with its queries' natural runs, real
   pairs, buffer placement, thread count and resident blocks an SM
   ("per_bucket", here and in phases 5, 6).
5. The rerank path at full size, on phase 4's index: the device
   embedding table (dim 256) is built and timed, then search_rerank runs
   over the same 4 batches (k=10, 64 candidates); the large-k fused
   kernel and the dots kernel must both launch, and per batch a seeded
   sample of >= 1,024 queries covering every cell must equal the plain
   scorer with the plain dots. Serving q/s is the median of 5 more
   passes. One batch's buckets at k=64 are compared in full and timed,
   and one batch's dots are timed, each as a run of launches between one
   pair of CUDA events: the kernel with the L2 warm and cold (a 128 MiB
   write before each launch) and with every row in a 16 MiB stretch of
   the table that the L2 holds, the plain version, and two yardsticks the
   port never calls: one float32 torch.bmm over the candidates gathered
   beforehand, and the whole function in PyTorch (gather, .float(),
   bmm).
6. The xla_rank, fused_dv and split paths at full size, on phase 4's
   index and batches: for each of scorer "xla_rank", scorer "fused_dv"
   and scorer "fused" with split_rows 128, search_stream's ids and scores
   for all queries must equal phase 4's, and the path's kernel (the
   rank-only kernel, the dv load stage, the dlim load stage) must have
   launched. Serving q/s is the median of 5 more passes; one batch's
   buckets are compared in full against the plain version and timed as
   the median of 5 warm runs. Also reported: the peak device memory over
   the xla_rank pass, the dv planes' bytes, the split pass's pieces and
   workspace buckets, and per path (and for phase 4's run) the median
   host-clock ms a batch spends in the engine's dispatch (planning, H2D,
   enqueue) and collect (D2H wait, assembly, merges).
   Phase graphs, on phase 4's index and batches after phase 6: for
   fused at k 10 (B1) and 64 (B2t), fused_dv (B5), xla_rank (B3) and
   split 128 (B1 dlim), every batch's key seen, then all 4 batches
   dispatched through their graphs at once (depth 8), each output held
   until the last is dispatched and then equal bit for bit to the eager
   _batch_step on the same inputs; with a sleep of max(50 ms, 4 x a
   warm dispatch) on the stream, a warm _dispatch must return while
   the stream is still busy. Reported: the captures and each capture's
   ms, the graphs and the pool's bytes, the host ms of a warm dispatch's
   planning and enqueue (prof.phase dispatch.plan, dispatch.enqueue)
   beside the same enqueue run eagerly; phase 8 adds both gates for the
   sharded engine at each shard count, and the "graphs:" line (printed
   after the bench's) phase 9's busy share and phase 10's q/s.
7. The lifecycle path at full size, on phase 4's corpus, index and
   batches (phase_lifecycle): a streaming build of the corpus in 8
   batches of 125,000, which the default policy compacts into one
   segment whose planes are torch.equal to phase 4's and whose results
   equal phase 4's on all queries; one delete_docs of a seeded 100,000
   ids on both engines, which must then agree on all queries, return no
   deleted id, and equal the plain scorer on a sample; one batch through
   scorer "fused_dv" and one split at 128 (both equal to the fused
   results), then compact(): the results stay, and the device bytes it
   frees must cover the old planes, the dv planes and the quantile
   tables (allocated after - before <= resident after - before + 5% of
   resident after), and its peak above its start must stay within the
   build rule of phase 4 with the compacted segment's resident bytes and
   nnz_cap (the streaming build's peak is logged against the same rule,
   not gated: its batches' segments are resident when the final compact
   builds); save, then SearchEngine.load on the card by default:
   the same resident bytes and results, and no layout grows on replay;
   the CLI (index, 16 searches, serve) with its default device on a
   2,000-doc corpus, whose printed hits must equal the library's. The
   fused kernel and its dv and dlim load stages must have launched.
   Reported: the seconds of the streaming build (and the share of its
   final compact), the delete, the compact, save and load; the peak
   device bytes of the build and the compact, and their rule's bytes;
   the checkpoint's bytes;
   serving q/s after the compact (the median of 5 passes).
8. The sharded engine at full size (phase_sharded), on phase 4's corpus
   and batches, every shard on the card: for each of 1, 2, 4 and 8
   shards a DistributedSearchEngine built from the corpus, whose results
   equal phase 4's on all queries, whose fused kernel launched once per
   shard and bucket, and whose build's peak above its start stays within
   the build rule of phase 4 with the sharded resident bytes and the
   triples of all shards. At 4 shards: scorer "xla_rank", split_rows 128
   and a host build (device_build = False; its value planes torch.equal
   to the device build's) equal phase 4's results, and search_rerank
   (k=10, 64 candidates, dim 256) equals phase 5's single-engine rerank;
   then the lifecycle beside phase 4's engine, which phase 7 left with
   the same delete: delete of phase 7's 100,000 ids, add_docs of 10,000
   new docs and compact, each equal to the single engine on all
   queries, then save and DistributedSearchEngine.load on 2 shards
   (elastic reshard), equal to the saved engine; the CLI's `index
   --shards 2` on a 2,000-doc corpus and its search and serve on the
   card, whose hits equal the library's. At each shard count the
   sharded step's graphs hold phase graphs' two gates (bits in flight,
   no wait). fused_search,
   fused_search_large_k, fused_search_split, rank_only and rerank_dots
   must each have launched on the sharded path. Reported per shard
   count: build seconds and peak bytes above the start, resident bytes,
   serving q/s (median of 3 passes), the host's dispatch and collect ms
   a batch; the time of each lifecycle step and the checkpoint's bytes.
9. The reference scorers and the entry points (phase_reference), on
   phase 4's corpus built again (phases 7-8 changed phase 4's engine)
   and its batches: every query through the packed step, pack_ds at
   block 512 then the rank-only kernel (rank_candidates_kernel; the
   reference's search_packed_ds with use_rank_pallas), queries grouped
   by pow-2 n_blocks (blocks_per_query, block_plan) and cut into chunks
   of 32M packed pairs: all 65,536 results must equal phase 4's, the
   kernel must have launched, and a seeded sample of >= 1,024 queries
   covering every group must equal the plain search_packed_ds; the
   kernel, its plain version and pack_ds timed (median of 5 warm runs)
   on batch 0's group with the most packed pairs. The dense reference
   (score_exact, then topk_ranked and topk_ranked_sort) on 256 sampled
   queries in chunks of 64 must equal phase 4's. SearchEngine on the
   card (default scorer and xla_rank) must equal the vectorized oracle
   on an 18,000-doc corpus, bm25 and tfidf, k 10 and 100, before and
   after a delete + add. entry() on the card must launch the rank-only
   kernel and equal the same step on CPU tensors; dryrun_multichip(8)
   must pass (its rankings equal the oracle's). search must record
   exactly the phases search.analyze, search.score, dispatch.plan,
   dispatch.enqueue, collect.wait and collect.assemble, and a trace
   (utils/prof.py trace, traces/chip_smoke_trace.json) of one
   search_stream pass, after one untraced pass that captures every
   batch's graph, must hold the fused kernel's events. Reported:
   the groups, the step's q/s, the timed group's ms and bound, and the
   card's busy share of the traced window (the union of its kernels
   over the span of all events), with the kernels' time by name, the
   union of the host's torch operators and the first kernel's start.
10. The port's benchmark (phase_bench), with the parent's engines freed
   first. In this process, the bench's own index
   (bench.build_synth_engine at its defaults: 1,000,000 docs, Zipf df
   at 60 postings a doc over 200,000 terms, doc/tf planes drawn on the
   card, so a row may hold a doc twice): batch 0 of its queries (16,384,
   make_batches) through the fused kernel must equal the dense
   reference on 256 of them and the xla_rank scorer (the rank-only
   kernel) on all, each kernel counted from 0 over its search. Then
   `python -m document_search_engine_tpu_torch bench` in a subprocess
   with every BENCH_* unset (bench.py's defaults: nq 16,384, k 10, 24
   iters, depth 8, 8 batches, 5 passes; the host build, sharded, pack,
   8M and stream legs), which must exit 0 within BENCH_TIMEOUT_S and
   print its JSON line with the sharded, 8M and stream legs present,
   a nonzero device pack time and step q/s, and the 8M leg's peak
   device bytes (m8.peak_bytes) below 16,000,000,000, the 16 GB chip on
   which the reference built the same leg; its log is passed on to
   stderr, and its log must show the fused kernel launched in each leg
   that serves (warm-up, primary, w/o analysis, the step alone, the
   sharded windows, 8M). Reported: the line, the w/o-analysis q/s and
   each leg's seconds, peak device bytes and kernel launches.

Phase tools (phase_tools), last, with the card freed of phase 10's
work: the port's tools (document_search_engine_tpu_torch/tools/) with
fixed arguments, their own lines sent to stderr. The differential fuzz:
48 trials from base seed 16 (seed stride 101), whose draws must cover
every scorer (fused, xla, xla_rank), shard count (0 = the single engine,
1, 2, 4, every shard on the card), split value (None, 2, 4, 16) and kind,
k > 16 and each fused route; every trial's engine must equal the oracle
in ids and scores after its build and after each step of its random
add/delete/compact history, and B1, dlim, B2t and the rank-only kernel
must each have launched. The segment curve at its defaults (96,000
docs, 30,000-term vocabulary, as 1, 2, 4, 8 and 16 streaming segments,
auto-compact off; 8,192 queries of 8 terms a batch, k 10, depth 8, 16
batches a pass, best of 2 passes): every count must return the
1-segment results, launch kernels and hold a step graph, and the
1-segment results of 1,024 seeded queries must equal the vectorized
oracle's. The host profile at its defaults (the bench's 1M index, 8,192
queries of 8 terms, best of 16): the dummy step must be captured into a
graph and every stage's time be positive. Then (phase_tools_ab) the
lever A/B, the batch-size A/B and the roofline at their defaults on one
bench index they share (1M docs, seed 1): step_ab's baseline and
block2048, split128, threads16, threads64 on 8,192 queries, each
bit-identical to the baseline with a graph captured after its apply;
nq_ab's legs 8,192 and 16,384 (5 interleaved passes, each leg with its
own plan layouts and graphs), every pass returning nq x iters rows with
no capture inside it; the roofline's 8,192-query batch, its captured
buckets' real postings equal to the natural plan's and no bucket timed
below its bound. Reported ("tools: ..."): the
fuzz's trials, seconds, captures and launches; the curve (q/s, relative
to 1 segment) and per count the build and warm-up seconds, graphs held,
launches a batch, dispatch.plan and dispatch.enqueue ms a batch, the
peak and reserved device bytes, the graph pool's bytes and the plan
cache; the host profile's analyze, dispatch (plan, enqueue) and
collect ms, the ceiling q/s and the cProfile's top 10 by cumulative
time; step_ab's ms, q/s, captures and peak bytes a setting; nq_ab's
passes (q/s, ms a batch, dispatch.plan and dispatch.enqueue ms,
captures), best, median and step-only q/s a leg; the roofline's peaks
and, per natural and per captured bucket, its stage bounds, bound,
dominant stage, placement, threads, resident blocks an SM and (captured)
measured ms.

stdout ends with the lifecycle path's JSON line, the sharded path's,
the reference path's, the bench's ("bench: ..."), phase graphs'
("graphs: ..."), phase tools' ("tools: ..."), the kernels' JSON
line (the rank-only kernel's launches: the xla_rank path's and phase
9's packed step's; the segment merge's launches in the segment curve's
timed passes and its time at the live index's batch),
the card's name and power limit, and {"ok": true,
"device": {...}} as the last line. Progress goes
to stderr. chip_ab.py runs this script in several trees in turn, for a
comparison on one card in one go.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FUSED_SOURCE = "document_search_engine_tpu_torch/csrc/fused_search.cu"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "fused_search": (
        FUSED_SOURCE, "document_search_engine_tpu/ops/fused_pallas.py:288"),
    "fused_search_large_k": (
        FUSED_SOURCE, "document_search_engine_tpu/ops/rank_pallas.py:318"),
    "rerank_dots": (
        "document_search_engine_tpu_torch/csrc/rerank_dots.cu",
        "document_search_engine_tpu/ops/rerank.py:149"),
    "rank_only": (
        "document_search_engine_tpu_torch/csrc/rank_only.cu",
        "document_search_engine_tpu/ops/rank_pallas.py:405"),
    "fused_search_dv": (
        FUSED_SOURCE, "document_search_engine_tpu/ops/fused_dv.py:119"),
    "fused_search_split": (
        FUSED_SOURCE, "document_search_engine_tpu/ops/fused_pallas.py:395"),
    # none of its own: it serves fused_search's buckets of r_c >=
    # ops/fused.py TILED_MIN_RC (without doc limits)
    "fused_tiled": (
        "document_search_engine_tpu_torch/csrc/fused_tiled.cu",
        "document_search_engine_tpu/ops/fused_pallas.py:288 (r_c >= "
        "TILED_MIN_RC)"),
    # none of its own: the JAX package merges segments on the host
    "segment_merge": (
        "document_search_engine_tpu_torch/csrc/segment_merge.cu",
        "none (document_search_engine_tpu/engine/engine.py's host merge)"),
}
# the card's peaks for bound_ms (H100 SXM data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
INT8_OPS = 1979e12
SCALE = float(np.float32(2.0**16))
CLIP = float(np.float32(65075262.0))
# the main path's size: the corpus and traffic of bench.py's streaming
# leg, never cut
N_DOCS, VOCAB, MEAN_LEN = 1_000_000, 200_000, 40
NQ, N_BATCHES, TERMS_PER_QUERY, K, DEPTH = 16384, 4, 8, 10, 2
SERVING_PASSES = 5  # timed search_stream passes after the counted one
TIMED_REPS = 5  # event-timed repetitions per version, after one warm run
# the rerank path (phase 5): search_rerank's defaults
RERANK_K, CANDIDATES, DIM = 10, 64, 256
# phase 6: (scorer, split_rows, kernels-line entry of the path's kernel)
PATHS = (
    ("xla_rank", None, "rank_only"),
    ("fused_dv", None, "fused_search_dv"),
    ("fused", 128, "fused_search_split"),
)
# phase 7: the streaming build's batch (8 batches), the docs one
# delete_docs call tombstones (10%), and the CLI's corpus and queries
STREAM_BATCH_DOCS, N_DELETE = 125_000, 100_000
CLI_DOCS, CLI_QUERIES = 2_000, 16
# phase 8: the shard counts (every shard on the one card), the count the
# further paths and the lifecycle run at, the count its checkpoint is
# reloaded on, the docs its add brings, and the timed serving passes
SHARD_COUNTS, SHARDED_AT, RESHARD_TO = (1, 2, 4, 8), 4, 2
N_ADD, SHARDED_PASSES = 10_000, 3
PLANES = ("post_doc", "post_val", "post_tf", "indptr", "row_start")
# phase 9: the packed step's block (the reference's search_packed_ds
# default, entry.py's) and its chunks of packed pairs (and the plain
# version's); the dense reference's sample and chunk (64 x 1M int32 =
# 256 MB of scores); the parity corpus (20 Newsgroups' ~18k docs,
# BASELINE.json:8) and its queries
PACK_BLOCK, PACK_CHUNK_ELEMS, PLAIN_CHUNK_ELEMS = 512, 32 << 20, 16 << 20
DENSE_SAMPLE, DENSE_CHUNK = 256, 64
PARITY_DOCS, PARITY_QUERIES = 18_000, 64
# phase 10: the bench's index at its defaults (bench.py's: 1M docs, Zipf
# df at 60 postings a doc over max(50,000, docs // 5) terms, seed 1), and
# the time limit of its subprocess
SYNTH_DOCS, SYNTH_AVG_TERMS, BENCH_TIMEOUT_S = 1_000_000, 60, 600
# the build gates (phases 4, 7, 8): a build's peak device bytes above its
# start may hold the index it builds, its uploaded int32 (row, doc, tf)
# triples (12 B each) and one chunk's workspace; and the bench's 8M leg
# must peak below the 16 GB chip on which the reference built it
TRIPLE_BYTES, BUILD_WORKSPACE_BYTES = 12, 512 << 20
M8_PEAK_LIMIT_BYTES = 16_000_000_000
# phase tools: the fuzz's base seed and trial count (chosen so that the
# trials draw every scorer, shard count, split value and kind, and k > 16)
# and the segment curve's oracle sample
FUZZ_BASE, FUZZ_TRIALS, SEG_ORACLE_SAMPLE = 16, 48, 1024


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}",
          file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Diff:
    """Running max |a - b| over every kernel-vs-plain comparison."""

    def __init__(self):
        self.max_abs = 0

    def check(self, got, want, what: str) -> None:
        got = got.cpu().numpy().astype(np.int64)
        want = want.cpu().numpy().astype(np.int64)
        err = int(np.abs(got - want).max()) if got.size else 0
        self.max_abs = max(self.max_abs, err)
        if err:
            bad = np.argwhere(got != want)[:5]
            raise AssertionError(
                f"{what}: kernel != plain at {bad.tolist()} "
                f"(max |diff| {err})"
            )


# ------------------------------------------------------------ phase 2
def csr_from_lens(rng, lens, doc_space, n_docs):
    """CSR rows of the given lengths, each of unique ascending docs drawn
    from [0, doc_space), in the aligned (X, 128) plane layout of
    index/builder.py, with sentinel doc n_docs in the padding. Returns (indptr, row_start,
    d2, v2)."""
    from document_search_engine_tpu_torch.index.builder import (
        aligned_geometry,
    )

    lens = np.asarray(lens, np.int64)
    n_terms = len(lens)
    indptr = np.zeros(n_terms + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    row_start, x_rows = aligned_geometry(indptr, 1)
    d2 = np.full(x_rows * 128, n_docs, np.int32)
    v2 = np.zeros(x_rows * 128, np.int32)
    for t in range(n_terms):
        docs = np.sort(
            rng.choice(doc_space, size=int(lens[t]), replace=False)
        )
        vals = rng.random(len(docs), dtype=np.float32) * 1.9 + 0.05
        lo = int(row_start[t])
        d2[lo : lo + len(docs)] = docs
        v2[lo : lo + len(docs)] = vals.view(np.int32)
    return (
        indptr.astype(np.int32), row_start.astype(np.int32),
        d2.reshape(x_rows, 128), v2.reshape(x_rows, 128),
    )


def aligned_csr(rng, n_terms, doc_space, max_len, n_docs):
    """csr_from_lens with random lengths in [0, max_len]."""
    return csr_from_lens(rng, rng.integers(0, max_len + 1, n_terms),
                         doc_space, n_docs)


def fused_name(k: int) -> str:
    """The kernels-line entry of the fused kernel's branch serving k."""
    return "fused_search" if k <= 16 else "fused_search_large_k"


def check_fused(device, diffs, d2, v2, tabs, nb, block, s, k, n_docs, rc,
                kb, what, cut=None) -> int:
    """One fused_search call, and one fused_search_dv call over the
    interleaved plane of the same planes, each against its plain
    version; returns hits. Where fused_search takes the tiled kernels
    (ops/tiled.py tiled_route), the fused kernel (B1) is launched on the
    same tables too: the tiled kernels against the plain version, B1 and
    their plain mirror, B1 against the plain version. With `cut` the
    kernels read planes cut after that many rows (the plain versions,
    which read whole blocks, keep them)."""
    import torch

    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops import fused_dv as FD
    from document_search_engine_tpu_torch.ops import tiled as T

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    kw = dict(n_blocks=nb, block=block, s=s, k=k, n_docs=n_docs,
              scale=SCALE, clip=CLIP)
    got = F.fused_search(t(d2[:cut]), t(v2[:cut]), *tabs, r_c=rc,
                         key_bits=kb, **kw)
    want = plain_on(device, d2, v2, *tabs[:3], nb, block, s, k, n_docs)
    dv = FD.interleave_planes(t(d2[:cut]), t(v2[:cut]))
    got_dv = FD.fused_search_dv(dv, *tabs, r_c=rc, key_bits=kb, **kw)
    want_dv = FD.fused_search_dv_plain(
        FD.interleave_planes(t(d2), t(v2)), *tabs[:3], **kw)
    diff = diffs[fused_name(k)]
    if T.tiled_route(mode="fused", k=k, split=False, r_c=rc, n_blocks=nb,
                     s=s):
        b1 = F.launch_fused((t(d2[:cut]), t(v2[:cut])), *tabs, None, r_c=rc,
                            key_bits=kb, **kw)
        mirror = T.tiled_search_plain(t(d2), t(v2), *tabs, block=block, k=k,
                                      n_docs=n_docs, scale=SCALE, clip=CLIP,
                                      r_c=rc)
        torch.cuda.synchronize()
        for other, name in ((want, "plain"), (b1, "B1"), (mirror, "mirror")):
            diffs["fused_tiled"].check(got[0], other[0],
                                       f"{what} tiled vs {name} vals")
            diffs["fused_tiled"].check(got[1], other[1],
                                       f"{what} tiled vs {name} docs")
        got = b1
    torch.cuda.synchronize()
    diff.check(got[0], want[0], what + " vals")
    diff.check(got[1], want[1], what + " docs")
    diffs["fused_search_dv"].check(got_dv[0], want_dv[0], what + " dv vals")
    diffs["fused_search_dv"].check(got_dv[1], want_dv[1], what + " dv docs")
    return int((got[0] > 0).sum())


def tight_rc(rm, block) -> int:
    """The smallest pow-2 region (rows) that holds every query's blocks."""
    from document_search_engine_tpu_torch.ops.fused import _compact_rows

    need_r = int(_compact_rows(rm[:, 0, :], block).sum(1).max())
    return 1 << int(np.ceil(np.log2(max(need_r, 1))))


def phase_kernels(device, diffs, seed: int = 0) -> int:
    """The fused kernel vs its plain version on random plans; returns
    cases checked. `diffs` maps kernels-line names to Diff."""
    import torch

    from document_search_engine_tpu_torch.index.builder import (
        aligned_geometry,
    )
    from document_search_engine_tpu_torch.ops import fused as F

    rng = np.random.default_rng(seed)
    # (n_terms, n_docs, max_len, nq, s, block, extra blocks, k, kb, dup)
    cases = [
        (40, 3000, 900, 64, 4, 512, 0, 10, "auto", False),
        (40, 3000, 900, 48, 4, 512, 3, 1, "zero", True),
        (30, 50000, 6000, 32, 8, 4096, 0, 16, "auto", True),  # r_c > 128
        (30, 50000, 6000, 32, 8, 4096, 2, 10, "zero", False),  # r_c > 128
        (24, 200000, 20000, 16, 8, 4096, 0, 10, "auto", False),  # large
        (50, 700, 300, 80, 2, 256, 1, 16, "auto", True),
        (12, 2_000_000, 400, 32, 4, 1024, 0, 10, "auto", False),  # kb > 0
        (20, 1_000_000_000, 400, 16, 4, 1024, 0, 10, "auto", False),
        # the large-k branch
        (40, 3000, 900, 64, 4, 512, 0, 64, "auto", True),
        (40, 3000, 900, 48, 4, 512, 3, 17, "zero", True),
        (30, 50000, 6000, 32, 8, 4096, 0, 128, "auto", True),  # r_c > 128
        (30, 50000, 6000, 32, 8, 4096, 2, 100, "zero", False),  # r_c > 128
        (24, 200000, 20000, 16, 8, 4096, 0, 32, "auto", False),  # large
        (50, 700, 30, 80, 2, 256, 1, 100, "auto", True),  # < k hits
        (50, 700, 300, 80, 2, 256, 1, 32, "zero", True),
        (12, 2_000_000, 400, 32, 4, 1024, 0, 64, "auto", False),  # kb > 0
        (20, 1_000_000_000, 400, 16, 4, 1024, 0, 128, "zero", False),
    ]
    n_checked = 0
    for ci, (n_terms, n_docs, max_len, nq, s, block, extra, k, kbm,
             dup) in enumerate(cases):
        # docs come from a smaller space than n_docs where n_docs is
        # large: n_docs sets the key width and the sentinel
        indptr, row_start, d2, v2 = aligned_csr(
            rng, n_terms, min(n_docs, 10 * max_len + 1000), max_len, n_docs
        )
        rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
        if dup:
            rows[:, -1] = rows[:, 0]  # equal docs from two slots: ties
        coeff = (rng.random((nq, s)) * 1.5 + 0.05).astype(np.float32)
        coeff[rng.random((nq, s)) < 0.3] = 0.0  # missing slots
        coeff[0] = 0.0  # one fully empty query
        lens = np.where(coeff > 0, indptr[rows + 1] - indptr[rows], 0)
        need_b = int((-(-lens // block)).sum(1).max())
        nb = 1 << int(np.ceil(np.log2(max(need_b + extra, 1))))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        tabs = F.expand_plan_tables(
            t(row_start), t(indptr), t(rows), t(coeff.view(np.int32)),
            nb, block,
        )
        r_c = tight_rc(tabs[1], block)
        kb = F.key_bits_for(s, n_docs) if kbm == "auto" else 0
        for rc in (r_c, 2 * r_c):  # tight and dominated regions
            what = (f"case {ci} (nq={nq} nb={nb} block={block} r_c={rc} "
                    f"k={k} kb={kb})")
            hits = check_fused(device, diffs, d2, v2, tabs, nb, block, s, k,
                               n_docs, rc, kb, what)
            log(f"kernel == plain: {what}, {hits} hits")
            n_checked += 1
    # winners crowded into one thread: one term over docs 0..n-1, so
    # position p of the sorted region holds doc p and the rank stage's
    # thread p % 512 scans it; docs p % 512 == 0 score highest (tied), so
    # thread 0 meets the first n / 512 winners, more than the 16 its
    # registers hold (n 12,000: shared memory; 20,000: workspace)
    for n, k, kbm in ((12_000, 64, "auto"), (20_000, 128, "zero"),
                      (20_000, 17, "auto")):
        indptr = np.array([0, n], np.int32)
        row_start, x_rows = aligned_geometry(indptr.astype(np.int64), 1)
        d2 = np.full(x_rows * 128, n, np.int32)
        v2 = np.zeros(x_rows * 128, np.int32)
        vals = (rng.random(n, dtype=np.float32) * 0.5 + 0.05)
        vals[::512] = np.float32(1.9)
        d2[:n] = np.arange(n, dtype=np.int32)
        v2[:n] = vals.view(np.int32)
        d2, v2 = d2.reshape(x_rows, 128), v2.reshape(x_rows, 128)
        nq, block = 8, 4096
        rows = np.zeros((nq, 2), np.int32)
        coeff = np.ones((nq, 2), np.float32)
        coeff[:, 1] = 0.0
        nb = 1 << int(np.ceil(np.log2(-(-n // block))))
        tabs = F.expand_plan_tables(
            t(row_start.astype(np.int32)), t(indptr), t(rows),
            t(coeff.view(np.int32)), nb, block,
        )
        rc = tight_rc(tabs[1], block)
        kb = F.key_bits_for(2, n) if kbm == "auto" else 0
        what = f"crowded winners (n={n} r_c={rc} k={k} kb={kb})"
        hits = check_fused(device, diffs, d2, v2, tabs, nb, block, 2, k, n,
                           rc, kb, what)
        log(f"kernel == plain: {what}, {hits} hits")
        n_checked += 1
    # an empty segment: no rows, every block skipped, all (-1, -1)
    t32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    d_e = t32(np.full((32, 128), 0, np.int32))
    rows = t32(np.zeros((16, 4), np.int32))
    cb = t32(np.full((16, 4), np.float32(1.0).view(np.int32)))
    sr, rm, ab, dst = F.expand_plan_tables(
        t32(np.zeros(0)), t32(np.zeros(1)), rows, cb, 4, 1024
    )
    from document_search_engine_tpu_torch.ops import fused_dv as FD

    dv_e = FD.interleave_planes(d_e, d_e)
    for k in (10, 64):
        kw = dict(n_blocks=4, block=1024, s=4, k=k, n_docs=0, scale=SCALE,
                  clip=CLIP, r_c=8, key_bits=2)
        for name, got in (
            (fused_name(k), F.fused_search(d_e, d_e, sr, rm, ab, dst, **kw)),
            ("fused_search_dv", FD.fused_search_dv(dv_e, sr, rm, ab, dst,
                                                   **kw)),
        ):
            diffs[name].check(got[0], torch.full_like(got[0], -1),
                              f"empty segment k={k} {name} vals")
            diffs[name].check(got[1], torch.full_like(got[1], -1),
                              f"empty segment k={k} {name} docs")
        n_checked += 1
    return n_checked


def block_sorted_rows(rng, nq, n_blocks, block, n_docs, s, fill_frac=0.7):
    """(d_key, ci) (nq, n_blocks * block) int32 rows in the layout the
    rank-only kernel takes (tests/test_rank_pallas.py
    make_block_sorted_rows): every aligned `block`-run doc-ascending with
    a sentinel tail, a doc at most once per run, only the first s runs
    filled, about a tenth of the contributions zero."""
    c = n_blocks * block
    d = np.full((nq, c), n_docs, np.int32)
    ci = np.zeros((nq, c), np.int32)
    for q in range(nq):
        for b in range(min(n_blocks, s)):
            n_valid = int(rng.integers(0, int(block * fill_frac) + 1))
            docs = np.sort(rng.choice(n_docs, size=min(n_valid, n_docs),
                                      replace=False).astype(np.int32))
            lo = b * block
            d[q, lo : lo + len(docs)] = docs
            vals = rng.integers(0, 50, len(docs)).astype(np.int32)
            vals[rng.random(len(docs)) < 0.1] = 0
            ci[q, lo : lo + len(docs)] = vals
    return d, ci


def phase_rank(device, diff, seed: int = 3) -> int:
    """The rank-only kernel vs packed.rank_candidates on block-sorted
    rows; returns cases checked."""
    import torch

    from document_search_engine_tpu_torch.ops.packed import rank_candidates
    from document_search_engine_tpu_torch.ops.rank import (
        rank_candidates_kernel,
    )

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    n = 0

    def check(d, ci, block, s, k, n_docs, what):
        got = rank_candidates_kernel(t(d), t(ci), 0, block=block, s=s, k=k,
                                     n_docs=n_docs)
        want = rank_candidates(t(d), t(ci), 0, s, k, n_docs)
        torch.cuda.synchronize()
        diff.check(got[0], want[0], what + " vals")
        diff.check(got[1], want[1], what + " gids")
        return int((got[0] > 0).sum())

    # (nq, n_blocks, block, s, n_docs): C from 1,024 to 131,072 pairs;
    # from C 16,384 on the launch has a workspace, which a query uses
    # when its real pairs do not fit shared memory
    for nq, nb, block, s, n_docs in (
        (16, 4, 256, 4, 500),
        (16, 8, 256, 8, 120),  # few docs: many repeated across runs
        (8, 16, 1024, 8, 3000),  # C 16,384, the largest in shared memory
        (8, 32, 1024, 32, 50000),
        (4, 128, 1024, 32, 200000),  # C 131,072
        (4, 512, 256, 8, 100000),  # C 131,072 in runs of 256
        (8, 64, 256, 1, 1000),  # s = 1
    ):
        d, ci = block_sorted_rows(rng, nq, nb, block, n_docs, s)
        d[0], ci[0] = n_docs, 0  # an empty query
        d[1], ci[1] = n_docs, 0  # a query of 5 docs: fewer than k hits
        d[1, :5], ci[1, :5] = np.arange(5), 7
        for k in (1, 10, 16, 17, 64, 128):
            what = (f"rank C={nb * block} block={block} s={s} k={k} "
                    f"n_docs={n_docs}")
            hits = check(d, ci, block, s, k, n_docs, what)
            n += 1
        log(f"rank kernel == plain: C={nb * block} block={block} s={s}, "
            f"k in (1, 10, 16, 17, 64, 128), {hits} hits at k=128")
    # winners crowded into one thread: one run of docs 0..m-1 at their
    # positions, the docs p % 512 == 0 scoring highest, so thread 0 scans
    # them all (C 16,384 and 32,768)
    for c, m, k in ((16384, 12000, 64), (32768, 20000, 128),
                    (32768, 20000, 17)):
        d = np.full((2, c), m, np.int32)
        ci = np.zeros((2, c), np.int32)
        d[:, :m] = np.arange(m)
        ci[:, :m] = rng.integers(1, 5, (2, m))
        ci[:, :m:512] = 1000
        what = f"rank crowded winners C={c} k={k}"
        hits = check(d, ci, c, 1, k, m, what)
        log(f"rank kernel == plain: {what}, {hits} hits")
        n += 1
    return n


# k of every case aimed at the merge: both sides of 16, and the maximum
MERGE_KS = (1, 10, 16, 17, 64, 128)


def merge_rank_rows(rng, c, run, n_docs):
    """Rows aimed at the rank stage's merge, in the rank-only kernel's
    layout ((n, c) int32 doc keys and contributions, every aligned `run`
    stretch ascending with a sentinel tail of doc n_docs): one natural
    run; a break at every run boundary; one short run beside one long
    one; three natural runs; all-sentinel runs between real ones; the
    same docs in several runs (equal keys, different contributions);
    exactly kk candidates for each kk of MERGE_KS, and five; winners
    crowded into one warp's stretch of the sorted region and into one
    thread's positions. Needs c >= 8 * run and n_docs >= c. Returns
    (names, d, ci, s): s bounds a doc's occurrences in a row."""
    units = c // run
    live = min(units, 128)

    def sample(n, lo=0, hi=n_docs):
        return np.sort(rng.choice(hi - lo, size=n, replace=False) + lo)

    def chop(docs):  # consecutive full runs, the last one partial
        return [docs[i : i + run] for i in range(0, len(docs), run)]

    cases = {
        "one run": chop(sample(c - run // 2)),
        "break at every run": [
            sample(int(rng.integers(1, run + 1))) for _ in range(live)],
        "1 pair beside a long run": (
            [sample(1, n_docs // 2)] + chop(sample((units - 1) * run))),
        "three natural runs": (
            chop(sample(2 * run)) + chop(sample(3 * run - 7))
            + chop(sample(run + 1))),
        "sentinel runs between": [
            sample(int(rng.integers(1, run + 1))) if u % 3 == 0
            else np.zeros(0, np.int64) for u in range(live)],
        "equal docs in 8 runs": [sample(run - 3)] * 8,
        "five candidates": [sample(3), sample(2)],
        "one warp's stretch": chop(np.arange(c - 2 * run)),
        "one thread's positions": chop(np.arange(c - 2 * run)),
    }
    for kk in MERGE_KS:
        docs = sample(kk)
        cases[f"exactly {kk} candidates"] = [docs[::2], docs[1::2]]
    d = np.full((len(cases), c), n_docs, np.int32)
    ci = np.zeros((len(cases), c), np.int32)
    for row, (name, parts) in enumerate(cases.items()):
        for u, docs in enumerate(parts):
            lo = u * run
            d[row, lo : lo + len(docs)] = docs
            vals = rng.integers(1, 50, len(docs))
            if "candidates" not in name:
                vals[rng.random(len(docs)) < 0.1] = 0
            if name == "one warp's stretch":  # the best 128 side by side
                vals[:] = np.where(docs < 128, 1000 + docs % 7, vals)
            if name == "one thread's positions":
                vals[:] = np.where(docs % 512 == 0, 1000, vals)
            ci[row, lo : lo + len(docs)] = vals
    return list(cases), d, ci, live


def rows_with_real_pairs(rng, c, run, n_docs, counts):
    """One row per count n in `counts`: exactly n real pairs in two
    natural runs (full runs first, then a second ascending stretch)."""
    d = np.full((len(counts), c), n_docs, np.int32)
    ci = np.zeros((len(counts), c), np.int32)
    for row, n in enumerate(counts):
        first = (n // 2) // run * run
        for lo, m in ((0, first), (first, n - first)):
            d[row, lo : lo + m] = np.sort(
                rng.choice(n_docs, size=m, replace=False))
            ci[row, lo : lo + m] = rng.integers(0, 50, m)
    return d, ci


def smem_words(units, c) -> int:
    """The 8-byte words of dynamic shared memory behind the run table of
    a rank-only launch over regions of c pairs in `units` stored units
    (csrc/rank.cuh region_smem_bytes): a query whose real pairs fit
    twice keeps both merge buffers there, once the first. The fused
    kernel's counterpart is ops/fused.py buffer_words."""
    from document_search_engine_tpu_torch.ops import fused as F

    table = (units + 2) // 2
    return min(table * 8 + c * 16, F._lib().dse_smem_max_bytes()) // 8 - table


def phase_merge_rank(device, diff, seed: int = 5) -> int:
    """The rank-only kernel on merge_rank_rows and on rows at the edges
    of the shared-memory capacity; returns cases checked."""
    import torch

    from document_search_engine_tpu_torch.ops.packed import rank_candidates
    from document_search_engine_tpu_torch.ops.rank import (
        rank_candidates_kernel,
    )

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    n = 0
    sets = []
    for c, run in ((2048, 256), (16384, 1024), (32768, 256), (131072, 1024)):
        names, d, ci, s = merge_rank_rows(rng, c, run, 4 * c)
        sets.append((f"merge rows C={c} run={run} ({len(names)} rows)", d, ci,
                     run, s, 4 * c))
    c, run = 32768, 1024
    sw = smem_words(c // run, c)
    edges = [sw // 2 - 1, sw // 2, sw // 2 + 1, sw - 1, sw, sw + 1]
    d, ci = rows_with_real_pairs(rng, c, run, 4 * c, edges)
    sets.append((f"real pairs {edges} around the shared-memory capacity, "
                 f"C={c}", d, ci, run, 2, 4 * c))
    for what, d, ci, run, s, n_docs in sets:
        for k in MERGE_KS:
            got = rank_candidates_kernel(t(d), t(ci), 0, block=run, s=s, k=k,
                                         n_docs=n_docs)
            want = rank_candidates(t(d), t(ci), 0, s, k, n_docs)
            torch.cuda.synchronize()
            diff.check(got[0], want[0], f"{what} k={k} vals")
            diff.check(got[1], want[1], f"{what} k={k} gids")
            n += 1
        log(f"rank kernel == plain: {what}, k in {MERGE_KS}")
    return n


def reorder_blocks(tabs, block, rng, reverse, skip):
    """The plan tables with each query's blocks in reverse order (every
    block boundary then breaks the doc order) and/or a share `skip` of
    the blocks skipped (srcrow -1); dstrow recomputed for the new order,
    the slot ids moving with their blocks."""
    import torch

    from document_search_engine_tpu_torch.ops import fused as F

    sr, rm, ab, dst = (x.clone() for x in tabs)
    slot = dst >> F.SLOT_SHIFT
    if reverse:
        sr, rm, ab, slot = (torch.flip(x, dims=[2]) for x in (sr, rm, ab, slot))
    if skip:
        drop = torch.from_numpy(rng.random(tuple(sr.shape)) < skip)
        sr = torch.where(drop.to(sr.device), torch.full_like(sr, -1), sr)
    crows = F._compact_rows(rm[:, 0, :], block)
    rows = (torch.cumsum(crows, dim=1) - crows).to(torch.int32)[:, None, :]
    return [x.contiguous() for x in (sr, rm, ab, rows | (slot << F.SLOT_SHIFT))]


def merge_plans(rng, device):
    """Plans aimed at the fused kernel's merge, as (what, d2, v2, plan
    tables, n_blocks, block, s, n_docs)."""
    import torch

    from document_search_engine_tpu_torch.ops import fused as F

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out = []

    def plan(what, lens, rows, coeff, block, n_docs, reverse=False, skip=0.0,
             extra=0, edit=None):
        rows = np.asarray(rows, np.int32)
        coeff = np.asarray(coeff, np.float32)
        indptr, row_start, d2, v2 = csr_from_lens(rng, lens, n_docs, n_docs)
        if edit is not None:
            edit(row_start, d2, v2)
        lens_q = np.where(coeff > 0, indptr[rows + 1] - indptr[rows], 0)
        need_b = int((-(-lens_q // block)).sum(1).max())
        nb = 1 << int(np.ceil(np.log2(max(need_b + extra, 1))))
        tabs = F.expand_plan_tables(t(row_start), t(indptr), t(rows),
                                    t(coeff.view(np.int32)), nb, block)
        if reverse or skip:
            tabs = reorder_blocks(tabs, block, rng, reverse, skip)
        out.append((what, d2, v2, tabs, nb, block, rows.shape[1], n_docs))
        return nb

    ones = lambda nq, s: np.ones((nq, s), np.float32)
    co = ones(4, 4)
    co[:, 1:] = 0.0
    plan("one run", [5000, 300, 300, 300], [[0, 1, 2, 3]] * 4, co, 512, 20000)
    rows = rng.integers(0, 6, (8, 4))
    plan("a break at every block, shared memory", [3000] * 6, rows,
         ones(8, 4), 128, 9000, reverse=True)
    plan("a break at every block, workspace", [9000] * 6, rows, ones(8, 4),
         256, 30000, reverse=True)
    plan("1 posting beside 40,000", [1, 60, 40000, 100],
         [[0, 2], [1, 2], [2, 0], [3, 3]], ones(4, 2), 4096, 100000)
    plan("1 posting beside 9,000", [1, 9000], [[0, 1], [1, 0]], ones(2, 2),
         1024, 50000)
    for s, live in ((4, 3), (8, 5)):
        co = ones(8, s) * (rng.random((8, s)) + 0.1).astype(np.float32)
        co[:, live:] = 0.0
        rows = rng.integers(0, 6, (8, s))
        lens = rng.integers(500, 2500, 6)
        plan(f"{live} runs", lens, rows, co, 512, 6000)
        plan(f"{live} runs, blocks skipped in between", lens, rows, co, 512,
             6000, skip=0.3, extra=3)
    plan("equal docs in 8 runs", [2500, 70],
         [[0] * 8, [1] * 8, [0, 1] * 4], ones(3, 8), 512, 5000)
    # real postings around the shared-memory capacity: two terms a query,
    # 4 blocks each, so 8 stored units and regions of 256 rows
    sw = F.buffer_words(256, 8)
    edges = [sw // 2 - 1, sw // 2, sw // 2 + 1, sw - 1, sw, sw + 1]
    lens = [m for n in edges for m in (n // 2, n - n // 2)]
    nb = plan(f"real postings {edges} around the shared-memory capacity",
              lens, [[2 * i, 2 * i + 1] for i in range(len(edges))],
              ones(len(edges), 2), 4096, 200000)
    if nb != 8 or tight_rc(out[-1][3][1], 4096) != 256:
        raise AssertionError("the capacity-edge plan changed its geometry")
    lens = list(MERGE_KS) + [5]
    plan("exactly k candidates, and five", lens,
         [[i, i] for i in range(len(lens))], ones(len(lens), 2), 128, 3000)

    def crowd(row_start, d2, v2):  # the best 128 docs side by side
        lo = int(row_start[0])
        v = v2.reshape(-1).view(np.float32)
        v[lo : lo + 12000] *= np.float32(0.25)
        v[lo : lo + 128] = np.float32(1.9)

    plan("winners in one warp's stretch", [12000, 50], [[0, 1]] * 2,
         ones(2, 2), 4096, 12000, edit=crowd)
    return out


def check_dlim(device, diff, d2t, v2t, tabs, dlim, nb, block, s, k, n_docs,
               kb, what):
    """The fused kernel with doc limits against search_packed_tables with
    the same limits, at the tight region size and twice it; returns the
    kernel's last output."""
    import torch

    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops.packed import (
        search_packed_tables,
    )

    kw = dict(n_blocks=nb, block=block, s=s, k=k, n_docs=n_docs)
    want = search_packed_tables(d2t, v2t, *tabs[:3], SCALE, CLIP, 0,
                                dlim=dlim, **kw)
    rc0 = tight_rc(tabs[1], block)
    for rc in (rc0, 2 * rc0):
        got = F.fused_search(d2t, v2t, *tabs, scale=SCALE, clip=CLIP,
                             r_c=rc, key_bits=kb, dlim=dlim, **kw)
        torch.cuda.synchronize()
        diff.check(got[0], want[0], f"{what} r_c={rc} vals")
        diff.check(got[1], want[1], f"{what} r_c={rc} docs")
    return got


def phase_merge_fused(device, diffs, seed: int = 4):
    """The fused kernel, its dv load stage and its doc-limit load stage
    on merge_plans, every k of MERGE_KS, unique keys and plain doc keys;
    returns (fused and dv cases, dlim cases)."""
    import torch

    from document_search_engine_tpu_torch.ops import fused as F

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    n_fused = n_dlim = 0
    for what, d2, v2, tabs, nb, block, s, n_docs in merge_plans(rng, device):
        nq = tabs[0].shape[0]
        rc = tight_rc(tabs[1], block)
        lim = np.sort(rng.integers(0, n_docs + 1, (nq, 2)), axis=1)
        lim[0] = (0, n_docs)
        dlim = t(lim.astype(np.int32).reshape(nq, 1, 2))
        d2t, v2t = t(d2), t(v2)
        for k in MERGE_KS:
            for kb in (F.key_bits_for(s, n_docs), 0):
                tag = f"merge: {what} (r_c={rc} k={k} kb={kb})"
                check_fused(device, diffs, d2, v2, tabs, nb, block, s, k,
                            n_docs, rc, kb, tag)
                n_fused += 1
                check_dlim(device, diffs["fused_search_split"], d2t, v2t,
                           tabs, dlim, nb, block, s, k, n_docs, kb,
                           tag + " dlim")
                n_dlim += 1
        log(f"kernel == plain: merge: {what}, r_c={rc}, k in {MERGE_KS}, "
            f"both key widths; fused, dv and dlim")
    return n_fused, n_dlim


def load_plans(rng, device):
    """Plans aimed at the fused kernel's load stage, as (what, d2, v2,
    plan tables, n_blocks, block, s, n_docs, region sizes r_c to run,
    doc limits or None, rows the kernel's planes are cut after or None).
    Each structure comes at three sizes, so that its queries' merge
    buffers lie in shared memory (both, or the first only) and in the
    workspace; every plan has an empty query."""
    import torch

    from document_search_engine_tpu_torch.index import builder as B
    from document_search_engine_tpu_torch.ops import fused as F

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out = []

    def plan(what, lens, rows, coeff, block, n_docs, extra=0, skip=0.0,
             rcs=None, cut_term=None):
        rows = np.asarray(rows, np.int32)
        coeff = np.asarray(coeff, np.float32).copy()
        coeff[0] = 0.0
        indptr, row_start, d2, v2 = csr_from_lens(rng, lens, n_docs, n_docs)
        lens_q = np.where(coeff > 0, indptr[rows + 1] - indptr[rows], 0)
        need_b = int((-(-lens_q // block)).sum(1).max())
        nb = 1 << int(np.ceil(np.log2(max(need_b + extra, 1))))
        tabs = F.expand_plan_tables(t(row_start), t(indptr), t(rows),
                                    t(coeff.view(np.int32)), nb, block)
        if skip:
            tabs = reorder_blocks(tabs, block, rng, False, skip)
        cut = None
        if cut_term is not None:  # the term's last row is the plane's
            end = int(row_start[cut_term] + lens[cut_term])
            cut = -(-end // 128)
        rc = tight_rc(tabs[1], block)
        if rcs and min(rcs) < rc:
            raise AssertionError(f"{what}: r_c {rcs} below the tight {rc}")
        out.append((what, d2, v2, tabs, nb, block, rows.shape[1], n_docs,
                    rcs or [rc], None, cut))

    ones = lambda nq, s: np.ones((nq, s), np.float32)
    # sizes: real pairs a query ~ scale * 1,000 (shared memory), ~20,000
    # (capped regions: the first buffer only), ~40,000 (the workspace)
    for scale in (1, 20, 40):
        tag = f" ({scale}k pairs)"
        lens = (np.array([130, 257, 515, 1023, 7, 1, 2, 3]) * scale) | 1
        plan("rem tails not a multiple of 4" + tag, lens,
             rng.integers(0, 8, (6, 4)), ones(6, 4), 1024, 50000 * scale)
        lens = rng.integers(150, 500, 6) * (2 * scale if scale > 20
                                            else scale) | 1
        plan("blocks skipped between real ones" + tag, lens,
             rng.integers(0, 6, (6, 4)), ones(6, 4), 256, 50000 * scale,
             extra=8, skip=0.35)
        # 128 plan blocks, few of them real: the plan scan's four steps
        plan("n_blocks 128" + tag, [scale * 1000 // 4 - 3] * 4,
             [[0, 1, 2, 3]] * 3, ones(3, 4), min(128 * scale, 4096),
             50000 * scale, extra=100)
        lens = [800 * scale + 1, 1100 * scale + 3, 333 * scale]
        plan("rows end at the plane's last row" + tag, lens,
             [[0, 1], [2, 1], [2, 2], [0, 2]], ones(4, 2), 4096,
             50000 * scale, cut_term=2)
    # exactly c real pairs: shared memory, the first buffer, the workspace
    for c in (2048, 16384, 32768):
        plan(f"n exactly c = {c}", [c, c // 2, c // 2, 100],
             [[3, 3], [0, 3], [1, 2]],
             ones(3, 2) * np.float32([[1, 1], [1, 0], [1, 1]]), 4096,
             4 * c)
    # r_c on each side of each thread-count threshold, small queries in
    # shared memory at each thread count; the same structure at 20 and
    # 40 times the size reaches the first-only and workspace placements
    # (the tight r_c, 1024 threads)
    rcs = sorted({r for b, _t in F.THREADS_BY_RC if b
                  for r in (b // 2, b, 2 * b)})
    for scale in (1, 20, 40):
        plan(f"regions on each side of the launch-shape thresholds "
             f"({scale}x)", np.array([300, 400, 77, 500]) * scale,
             [[0, 1, 2], [3, 3, 3], [1, 3, 0], [2, 2, 2], [0, 0, 3],
              [1, 1, 1]], ones(6, 3), 512, 30000 * scale,
             rcs=rcs if scale == 1 else None)
    # doc-range pieces whose first row starts below d_lo, at each size
    for scale in (1, 10, 40):
        n_docs, block, s, nq, m = 30000 * scale, 4096, 4, 4, 2
        lens = rng.integers(600, 1200, 6) * scale | 1
        indptr, row_start, d2, v2 = csr_from_lens(rng, lens, n_docs, n_docs)
        q_p = B.SPLIT_QUANTILES
        offs = B.device_row_doc_quantiles(t(d2), t(indptr), t(row_start),
                                          q_p, n_docs)
        rows = np.repeat(rng.integers(0, 6, (nq, s)).astype(np.int32), m, 0)
        coeff = np.ones(rows.shape, np.float32)
        coeff[:m] = 0.0
        pno = np.tile(np.arange(m), nq)
        cols = np.stack([pno * q_p // m, (pno + 1) * q_p // m], 1)
        offs_h = offs.cpu().numpy()
        lo = offs_h[rows, cols[:, 0:1]]
        lens_p = offs_h[rows, cols[:, 1:2]] - (lo - lo % 128)
        nb = 1 << int(np.ceil(np.log2(int((-(-lens_p // block)).sum(1)
                                          .max()))))
        tabs = F.expand_plan_tables(
            t(row_start), t(indptr), t(rows), t(coeff.view(np.int32)), nb,
            block, offs_dev=offs, cols=t(cols.astype(np.int32)))
        dlim = (cols * n_docs // q_p).astype(np.int32).reshape(-1, 1, 2)
        if not ((lo % 128 != 0) & (coeff > 0)).any():
            raise AssertionError("no piece starts below its d_lo")
        out.append((f"doc-range pieces ({scale}k pairs)", d2, v2, tabs, nb,
                    block, s, n_docs, [tight_rc(tabs[1], block)], t(dlim),
                    None))
    return out


def load_coverage(tabs, nb, block, rc, seen):
    """Adds each query's buffer placement (the kernel's decision, from
    the ops/fused.py mirror) to `seen`."""
    from document_search_engine_tpu_torch.ops import fused as F

    words = F.buffer_words(rc, nb)
    for u in F.load_units(*(x.cpu() for x in tabs), block=block, r_c=rc):
        seen.add(F.placement(int(u["off"][-1]), words))


def phase_load_fused(device, diffs, seed: int = 6):
    """The fused kernel, its dv load stage and its doc-limit load stage on
    load_plans, every k of MERGE_KS, both key widths; fails unless each
    structure met every buffer placement. Returns (fused and dv cases,
    dlim cases)."""
    import torch

    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops.packed import (
        search_packed_tables,
    )

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    n_fused = n_dlim = 0
    seen = {}  # structure -> the placements its queries met
    for (what, d2, v2, tabs, nb, block, s, n_docs, rcs, dlim,
         cut) in load_plans(rng, device):
        met = seen.setdefault(what.split(" (")[0].split(" = ")[0], set())
        nq = tabs[0].shape[0]
        if dlim is None:
            lim = np.sort(rng.integers(0, n_docs + 1, (nq, 2)), axis=1)
            lim[1] = (0, n_docs)
            dlim = t(lim.astype(np.int32).reshape(nq, 1, 2))
        d2t, v2t = t(d2), t(v2)
        kw = dict(n_blocks=nb, block=block, s=s, n_docs=n_docs)
        for rc in rcs:
            load_coverage(tabs, nb, block, rc, met)
            for k in MERGE_KS:
                want = search_packed_tables(d2t, v2t, *tabs[:3], SCALE, CLIP,
                                            0, dlim=dlim, k=k, **kw)
                for kb in (F.key_bits_for(s, n_docs), 0):
                    tag = (f"load: {what} (r_c={rc} threads="
                           f"{F.launch_threads(rc)} k={k} kb={kb})")
                    check_fused(device, diffs, d2, v2, tabs, nb, block, s, k,
                                n_docs, rc, kb, tag, cut=cut)
                    n_fused += 1
                    got = F.fused_search(d2t[:cut], v2t[:cut], *tabs,
                                         scale=SCALE, clip=CLIP, r_c=rc,
                                         key_bits=kb, dlim=dlim, k=k, **kw)
                    torch.cuda.synchronize()
                    diff = diffs["fused_search_split"]
                    diff.check(got[0], want[0], tag + " dlim vals")
                    diff.check(got[1], want[1], tag + " dlim docs")
                    n_dlim += 1
        log(f"kernel == plain: load: {what}, r_c {rcs}, k in {MERGE_KS}, "
            f"both key widths; fused, dv and dlim")
    # every structure in every placement
    for what, met in seen.items():
        if met != {"shared", "first", "workspace"}:
            raise AssertionError(f"load: {what} met only {sorted(met)}")
    log("load cases: every structure met every buffer placement")
    return n_fused, n_dlim


def phase_split(device, diff, seed: int = 2) -> int:
    """The fused kernel's doc-limit load stage vs search_packed_tables
    with the same dlim; returns cases checked."""
    import torch

    from document_search_engine_tpu_torch.index import builder as B
    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops.packed import (
        search_packed_tables,
    )
    from document_search_engine_tpu_torch.ops.schedule import _piece_lens

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    p = B.SPLIT_QUANTILES
    n, n_head = 0, 0

    def check(*args):
        return check_dlim(device, diff, *args)

    # (n_terms, n_docs, max_len, nq, s, block, k, kb)
    for n_terms, n_docs, max_len, nq, s, block, k, kbm in (
        (40, 3000, 900, 32, 4, 512, 10, "auto"),
        (40, 3000, 900, 32, 4, 512, 64, "zero"),
        (30, 50000, 6000, 16, 8, 4096, 16, "auto"),  # r_c > 128 rows
        (30, 50000, 6000, 16, 8, 4096, 128, "zero"),
        (12, 2_000_000, 400, 32, 4, 1024, 10, "auto"),  # docs in 1/400
        (20, 1_000_000_000, 400, 16, 4, 1024, 17, "zero"),
    ):
        indptr, row_start, d2, v2 = aligned_csr(
            rng, n_terms, min(n_docs, 10 * max_len + 1000), max_len, n_docs
        )
        d2t, v2t = t(d2), t(v2)
        offs_d = B.device_row_doc_quantiles(d2t, t(indptr), t(row_start), p,
                                            n_docs)
        flat = d2.reshape(-1)
        post_doc = np.concatenate([
            flat[row_start[i] : row_start[i] + indptr[i + 1] - indptr[i]]
            for i in range(n_terms)
        ])
        offs_h = B.host_row_doc_quantiles(indptr, post_doc, p, n_docs)
        np.testing.assert_array_equal(offs_d.cpu().numpy(), offs_h,
                                      "device quantiles")
        rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
        rows[:, -1] = rows[:, 0]  # equal docs from two slots: ties
        coeff = (rng.random((nq, s)) * 1.5 + 0.05).astype(np.float32)
        coeff[rng.random((nq, s)) < 0.3] = 0.0
        coeff[0] = 0.0
        lens = np.where(coeff > 0, indptr[rows + 1] - indptr[rows], 0)
        kb = F.key_bits_for(s, n_docs) if kbm == "auto" else 0
        # the unsplit plan: the yardstick for the merged pieces, and the
        # plan for arbitrary limits
        nb0 = 1 << int(np.ceil(np.log2(max(int(
            (-(-lens // block)).sum(1).max()), 1))))
        tabs0 = F.expand_plan_tables(t(row_start), t(indptr), t(rows),
                                     t(coeff.view(np.int32)), nb0, block)
        whole = search_packed_tables(d2t, v2t, *tabs0[:3], SCALE, CLIP, 0,
                                     n_blocks=nb0, block=block, s=s, k=k,
                                     n_docs=n_docs)
        whole = [x.cpu().numpy() for x in whole]
        for m in (2, 4, 8):
            qidx = np.repeat(np.arange(nq), m)
            pno = np.tile(np.arange(m), nq)
            cols = np.stack([pno * p // m, (pno + 1) * p // m], 1)
            cols = cols.astype(np.int32)
            lens_p = _piece_lens(lens, rows, offs_h, qidx, cols)
            nb = 1 << int(np.ceil(np.log2(max(int(
                (-(-lens_p // block)).sum(1).max()), 1))))
            tabs = F.expand_plan_tables(
                t(row_start), t(indptr), t(rows[qidx]),
                t(coeff[qidx].view(np.int32)), nb, block,
                offs_dev=offs_d, cols=t(cols),
            )
            dlim = t((cols.astype(np.int64) * n_docs // p).astype(np.int32)
                     .reshape(-1, 1, 2))
            lo = offs_h[rows[qidx], cols[:, 0:1]]
            n_head += int(((lo % 128 != 0) & (coeff[qidx] > 0)).sum())
            what = f"pieces m={m} n_docs={n_docs} block={block} k={k} kb={kb}"
            got = check(d2t, v2t, tabs, dlim, nb, block, s, k, n_docs, kb,
                        what)
            # the merged pieces equal the unsplit ranking
            pv = got[0].cpu().numpy().reshape(nq, m * k)
            pd = got[1].cpu().numpy().reshape(nq, m * k)
            order = np.lexsort((pd, -pv.astype(np.int64)), axis=-1)[:, :k]
            mv = np.take_along_axis(pv, order, 1)
            md = np.take_along_axis(pd, order, 1)
            np.testing.assert_array_equal(np.where(mv > 0, mv, -1), whole[0],
                                          what + " merged vals")
            np.testing.assert_array_equal(np.where(mv > 0, md, -1), whole[1],
                                          what + " merged docs")
            log(f"dlim kernel == plain: {what}, merged == unsplit")
            n += 1
        # arbitrary limits on the unsplit plan: empty, from 0, to n_docs,
        # the whole range, and random ranges
        top = int(d2[d2 < n_docs].max()) + 1
        lim = np.sort(rng.integers(0, top, (nq, 2)), axis=1)
        lim[1] = (5, 5)
        lim[2] = (0, top // 3)
        lim[3] = (top // 3, n_docs)
        lim[4] = (0, n_docs)
        what = f"arbitrary limits n_docs={n_docs} block={block} k={k} kb={kb}"
        check(d2t, v2t, tabs0, t(lim.astype(np.int32).reshape(nq, 1, 2)),
              nb0, block, s, k, n_docs, kb, what)
        log(f"dlim kernel == plain: {what}")
        n += 1
    if n_head == 0:
        raise AssertionError("no piece started below its d_lo")
    log(f"dlim: {n_head} piece slots start inside a 128-record row")
    return n


DOTS_DIMS = (64, 100, 256, 1024)
DOTS_KS = (1, 10, 16, 64, 65, 200)


def int8_rows(device, a, offset):
    """The int8 array `a` on the card, contiguous, starting `offset`
    bytes past a fresh allocation's (512-byte aligned) base: offset 0
    lets the dots kernel read 16 bytes a load, offset 4 only 4."""
    import torch

    buf = torch.empty(a.size + offset, dtype=torch.int8, device=device)
    out = buf[offset:].view(a.shape)
    out.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return out


def phase_dots(device, diff: Diff, seed: int = 1) -> int:
    """The rerank dots kernel vs gather_and_dot_plain on random int8
    tables: dim in DOTS_DIMS, each with 16-byte and 4-byte loads (emb and
    qemb 16-byte aligned, or 4 bytes past it; dim 100 only the latter), K
    in DOTS_KS, nq not a multiple of any queries a block; dead (-1) and
    repeated gids, a query with no live candidate and the table's last
    row. Returns cases checked."""
    import torch

    from document_search_engine_tpu_torch.ops import rerank as R

    rng = np.random.default_rng(seed)
    n_docs, nq = 5000, 301
    n = 0
    for dim in DOTS_DIMS:
        emb = rng.integers(-R.EMB_CLIP, R.EMB_CLIP + 1, (n_docs, dim))
        emb = emb.astype(np.int8)
        ssq = (emb.astype(np.int32) ** 2).sum(1).astype(np.int32)
        qemb = rng.integers(-R.EMB_CLIP, R.EMB_CLIP + 1, (nq, dim))
        qemb = qemb.astype(np.int8)
        for kc in DOTS_KS:
            gids = rng.integers(0, n_docs, (nq, kc)).astype(np.int32)
            gids[rng.random((nq, kc)) < 0.1] = -1  # dead candidates
            gids[:, -1] = gids[:, 0]  # repeated gids
            gids[1, kc // 2] = n_docs - 1  # the table's last row
            gids[0] = -1  # a query with no live candidate
            ssq_t = torch.from_numpy(ssq).to(device)
            g_t = torch.from_numpy(gids).to(device)
            for offset in (0, 4) if dim % 16 == 0 else (4,):
                e_t = int8_rows(device, emb, offset)
                q_t = int8_rows(device, qemb, offset)
                vec = 16 if offset == 0 else 4
                if (e_t.data_ptr() % 16 == 0) != (vec == 16):
                    raise AssertionError("emb is not aligned as intended")
                got = R.gather_and_dot(e_t, ssq_t, q_t, g_t)
                want = R.gather_and_dot_plain(e_t, ssq_t, q_t, g_t)
                torch.cuda.synchronize()
                what = f"dots dim={dim} K={kc} {vec}-byte loads"
                diff.check(got[0], want[0], what + " dots")
                diff.check(got[1], want[1], what + " ssq")
                n += 1
        log(f"kernel == plain: dots dim={dim}, K in {DOTS_KS}, "
            f"{'16- and 4-byte' if dim % 16 == 0 else '4-byte'} loads")
    return n


# the segment merge's cases: (queries, segments, k, score range, hit
# share); the first is the live cell's batch (1,024 queries, 10 segments,
# k 100), the second its shape at k 10
SEGMENT_MERGE_CASES = ((1024, 10, 100, 5, 0.5), (1024, 10, 10, 5, 0.5),
                       (1024, 10, 100, 1 << 30, 1.0), (1024, 3, 128, 3, 0.9),
                       (333, 2, 1, 2, 0.5), (64, 17, 64, 4, 1.0))


def segment_merge_inputs(rng, nq, n_seg, k, v_max, hit_share):
    """Random ranked lists as the batch step stacks them: per (query,
    segment) up to k hits ranked (score desc, gid asc), gids disjoint
    across segments and scores in [1, v_max], (-1, -1) past the last; a
    fifth of the lists absent (pos -1), their rows left as junk among the
    others; query 0 in no segment, query 1 with full lists in every one.
    Returns (stacked (rows, 2k), pos (nq, n_seg)) int32 numpy arrays."""
    step = 1 << 10
    span = k * step
    g = (np.arange(n_seg)[None, :, None] * span
         + np.arange(k)[None, None, :] * step
         + rng.integers(0, step, (nq, n_seg, k)))
    v = rng.integers(1, v_max + 1, (nq, n_seg, k))
    flat_g, flat_v = g.reshape(-1, k), v.reshape(-1, k)
    order = np.lexsort((flat_g, -flat_v), axis=-1)
    v = np.take_along_axis(flat_v, order, 1).reshape(nq, n_seg, k)
    g = np.take_along_axis(flat_g, order, 1).reshape(nq, n_seg, k)
    hits = rng.binomial(k, hit_share, (nq, n_seg))
    hits[1] = k
    dead = np.arange(k)[None, None, :] >= hits[:, :, None]
    v[dead], g[dead] = -1, -1
    present = rng.random((nq, n_seg)) > 0.2
    present[0], present[1] = False, True
    n_rows = nq * n_seg + 5
    rows = rng.permutation(n_rows)[: nq * n_seg].reshape(nq, n_seg)
    stacked = rng.integers(-3, 1 << 20, (n_rows, 2 * k))
    stacked[rows] = np.concatenate([v, g], 2)
    pos = np.where(present, rows, -1)
    return stacked.astype(np.int32), pos.astype(np.int32)


def phase_segment_merge(device, diff: Diff, seed: int = 12):
    """The cross-segment merge kernel (csrc/segment_merge.cu) vs its plain
    mirror on SEGMENT_MERGE_CASES, then, at the live cell's shape and at
    k 10, the kernel timed (a run of 100 launches, L2-warm), the mirror on
    the card and the bytes bound (the present lists, pos and the answer,
    each once, at 3.35 TB/s). Returns (cases checked, timings)."""
    import torch

    from document_search_engine_tpu_torch.ops.segment_merge import (
        segment_merge,
        segment_merge_plain,
    )

    rng = np.random.default_rng(seed)
    n, timings = 0, {}
    for nq, n_seg, k, v_max, hit_share in SEGMENT_MERGE_CASES:
        stacked, pos = segment_merge_inputs(rng, nq, n_seg, k, v_max,
                                            hit_share)
        st, ps = (torch.from_numpy(a).to(device) for a in (stacked, pos))
        got = segment_merge(st, ps, k)
        want = segment_merge_plain(st, ps, k)
        torch.cuda.synchronize()
        what = f"segment merge nq={nq} S={n_seg} k={k} scores<={v_max}"
        diff.check(got, want, what)
        n += 1
        if v_max == 5 and n_seg == 10:
            ms, runs = loop_ms(lambda: segment_merge(st, ps, k), 100)
            plain_ms, _ = loop_ms(lambda: segment_merge_plain(st, ps, k), 5)
            nbytes = (int((pos >= 0).sum()) * 2 * k + pos.size
                      + nq * 2 * k) * 4
            timings[f"k{k}"] = {
                "shape": [nq, n_seg, k], "ms": ms, "ms_runs": runs,
                "plain_ms": plain_ms, "bytes": nbytes,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes"}
    log(f"kernel == plain: segment merge, {n} cases; {json.dumps(timings)}")
    return n, timings


def plain_on(device, d2, v2, sr, rm, ab, nb, block, s, k, n_docs):
    """The plain PyTorch version on the same card (doc_base 0)."""
    import torch

    from document_search_engine_tpu_torch.ops.packed import (
        search_packed_tables,
    )

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return search_packed_tables(
        t(d2), t(v2), sr, rm, ab, SCALE, CLIP, 0, n_blocks=nb,
        block=block, s=s, k=k, n_docs=n_docs,
    )


# ------------------------------------------------------------ phase 3
def phase_oracle(device) -> int:
    """Port engine on the card vs the frozen CPU oracle, and its
    search_rerank vs the same call on a CPU engine."""
    from document_search_engine_tpu_torch import (
        IndexConfig,
        ScoringConfig,
        SearchEngine,
    )
    from document_search_engine_tpu_torch.corpus.synth import (
        synth_corpus,
        synth_queries,
    )
    from document_search_engine_tpu_torch.oracle import OracleEngine

    n = 0
    for kind in ("bm25", "tfidf"):
        for seed, n_docs in ((0, 120), (6, 3000)):
            docs = synth_corpus(
                n_docs=n_docs, vocab_size=800 if n_docs < 1000 else 5000,
                mean_len=40, seed=seed,
            )
            queries = synth_queries(docs, n_queries=40, terms_per_query=5,
                                    seed=seed + 1)
            queries += ["", "zzznotaword", docs[0].split()[0],
                        " ".join(docs[1].split()[:40])]
            cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
            eng = SearchEngine(cfg, device=device)
            eng.build(docs[: n_docs // 2])
            eng.add_docs(docs[n_docs // 2 :])  # two segments: host merge
            ora = OracleEngine(cfg)
            ora.build(docs)
            # k > 16 takes the kernel's large-k branch, k > 128 the
            # plain scorer over uncompacted plans
            for k in (1, 10, 16, 17, 64, 128, 200):
                e_ids, e_sc = eng.search(queries, k=k)
                o_ids, o_sc = ora.search(queries, k=k)
                np.testing.assert_array_equal(e_ids, o_ids, f"{kind} k={k}")
                np.testing.assert_array_equal(e_sc, o_sc, f"{kind} k={k}")
                n += 1
            got = list(eng.search_stream(
                [queries[:7], queries[7:8], [], queries[8:]], k=10
            ))
            o_ids, o_sc = ora.search(queries, k=10)
            np.testing.assert_array_equal(
                np.concatenate([g[0] for g in got]), o_ids, "stream ids")
            np.testing.assert_array_equal(
                np.concatenate([g[1] for g in got]), o_sc, "stream scores")
            log(f"oracle parity: {kind}, {n_docs} docs, 2 segments, "
                f"k in (1, 10, 16, 17, 64, 128, 200) and search_stream")
            # the three further paths over three segments, one of them
            # empty-vocabulary; split_rows 2 splits every real query
            half = n_docs // 2
            parts = (docs[:half], docs[half:], ["", "!!! ???"])
            ora3 = OracleEngine(cfg)
            for part in parts:
                ora3.add_docs(part)
            ks = (1, 10, 16, 17, 64, 128, 200)
            want3 = {k: ora3.search(queries, k=k) for k in ks}
            for scorer, split in (("xla_rank", None), ("fused_dv", None),
                                  ("fused", 2)):
                e3 = SearchEngine(cfg, device=device)
                e3.scorer, e3.split_rows = scorer, split
                for part in parts:
                    e3.add_docs(part)
                for k in ks:
                    got = e3.search(queries, k=k)
                    what = f"{kind} {scorer} split={split} k={k}"
                    np.testing.assert_array_equal(got[0], want3[k][0], what)
                    np.testing.assert_array_equal(got[1], want3[k][1], what)
                    n += 1
                got = list(e3.search_stream(
                    [queries[:7], [], queries[7:]], k=10))
                for i, name in ((0, "ids"), (1, "scores")):
                    np.testing.assert_array_equal(
                        np.concatenate([g[i] for g in got]), want3[10][i],
                        f"{kind} {scorer} split={split} stream {name}")
                log(f"oracle parity: {kind}, {n_docs} docs, 3 segments, "
                    f"scorer {scorer} split_rows {split}, k up to 200 and "
                    f"search_stream")
            # rerank: a second segment whose docs tokenize to nothing
            engines = [SearchEngine(cfg, device=dev) for dev in (device, "cpu")]
            for e in engines:
                e.build(docs)
                e.add_docs(["", "!!! ???"])
            for k, cand in ((10, 64), (5, 16)):
                got = engines[0].search_rerank(queries, k=k, candidates=cand)
                want = engines[1].search_rerank(queries, k=k, candidates=cand)
                for g, w, name in zip(got, want, ("ids", "rerank", "lex")):
                    np.testing.assert_array_equal(
                        g, w, f"{kind} rerank k={k} {name}")
                n += 1
            log(f"search_rerank parity: {kind}, {n_docs} docs + an "
                f"empty-vocabulary segment, card == cpu")
    return n


# ------------------------------------------------------------ phase 4
def bucket_calls(captured):
    """Per bucket of one captured _batch_step: (segment, plan tables,
    the kernel's keyword arguments, dlim or None, dv plane or None).
    Fails when the step has no bucket."""
    import torch

    from document_search_engine_tpu_torch.ops.fused import (
        expand_plan_tables,
        key_bits_for,
    )

    segments, rows_cat, cbits_cat = captured["args"]
    kw = captured["kw"]
    split_p = kw.get("split_p", 0)
    dv_planes = kw.get("dv_planes")
    calls, off = [], 0
    for si, ((n_docs, _base, seg), (_nd, s, buckets)) in enumerate(
        zip(segments, kw["plan"])
    ):
        for n_blocks, block, bq, r_c in buckets:
            cols = dlim = None
            if split_p:
                cols = kw["cols_cat"][off : off + bq]
                dlim = ((cols.long() * n_docs) // split_p).to(
                    torch.int32).reshape(bq, 1, 2)
            tabs = expand_plan_tables(
                seg.row_start, seg.indptr, rows_cat[off : off + bq],
                cbits_cat[off : off + bq], n_blocks, block,
                offs_dev=kw["offs_devs"][si] if split_p else None, cols=cols,
            )
            off += bq
            calls.append((seg, tabs, dict(
                n_blocks=n_blocks, block=block, s=s, k=kw["k"],
                n_docs=n_docs, scale=kw["scale"], clip=kw["clip"], r_c=r_c,
                key_bits=key_bits_for(s, n_docs),
            ), dlim, None if dv_planes is None else dv_planes[si]))
    if not calls:
        raise AssertionError("the captured step has no bucket")
    return calls


def plain_chunks(seg, tabs, p, dlim=None, dv=None, chunk_elems=64 << 20):
    """The plain version over a bucket, in query chunks whose
    (rows, n_blocks * block) buffers stay ~64M elements: the fused
    kernel's (with dlim when given), or the dv load stage's."""
    import torch

    from document_search_engine_tpu_torch.ops.fused_dv import (
        fused_search_dv_plain,
    )
    from document_search_engine_tpu_torch.ops.packed import (
        search_packed_tables,
    )

    nq = tabs[0].shape[0]
    step = max(1, chunk_elems // (p["n_blocks"] * p["block"]))
    kw = dict(n_blocks=p["n_blocks"], block=p["block"], s=p["s"], k=p["k"],
              n_docs=p["n_docs"])
    vs, ds = [], []
    for lo in range(0, nq, step):
        sr, rm, ab = (x[lo : lo + step] for x in tabs[:3])
        if dv is not None:
            v, d = fused_search_dv_plain(dv, sr, rm, ab, scale=p["scale"],
                                         clip=p["clip"], **kw)
        else:
            v, d = search_packed_tables(
                seg.post_doc, seg.post_val, sr, rm, ab, p["scale"],
                p["clip"], 0, dlim=None if dlim is None else
                dlim[lo : lo + step], **kw,
            )
        vs.append(v)
        ds.append(d)
    return torch.cat(vs), torch.cat(ds)


def timed(fn, reps=TIMED_REPS):
    """One warm call, then `reps` calls each timed with CUDA events.
    Returns (last output, median ms, every ms)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = fn()
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    return out, float(np.median(times)), times


def loop_ms(fn, n, reps=TIMED_REPS, scratch=None):
    """ms a call of fn: n calls between one pair of CUDA events, divided
    by n, the median of `reps` such runs after one warm call. With
    `scratch` (a tensor larger than the 50 MB L2), every call follows a
    write of it, so that fn finds the cache full of other lines, and the
    same run of writes alone is subtracted. Returns (median ms, each
    run's ms)."""
    import torch

    def run(body):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(n):
            body()
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1)

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if scratch is None:
            times.append(run(fn) / n)
        else:
            both = run(lambda: (scratch.zero_(), fn()))
            times.append((both - run(scratch.zero_)) / n)
    return float(np.median(times)), times


def sample_cells(rng, cell_list, nq, sample):
    """A seeded sample of >= `sample` query indices that draws from every
    non-empty layout cell of one batch."""
    live = [idx for idx, _bq in cell_list if len(idx)]
    per = max(1, -(-sample // len(live)))
    pick = np.unique(np.concatenate(
        [rng.choice(idx, size=min(per, len(idx)), replace=False)
         for idx in live]
    ))
    if len(pick) < sample:
        rest = np.setdiff1d(np.arange(nq), pick)
        pick = np.union1d(pick, rng.choice(
            rest, size=sample - len(pick), replace=False))
    return pick, len(live)


def host_timers(eng):
    """Wraps eng._dispatch and eng._collect so that each call records its
    host-clock ms (the dispatch: planning, H2D and enqueue; the collect:
    the D2H wait and assembly) and each dispatch its future. Returns
    (record, restore)."""
    rec = {"dispatch_ms": [], "collect_ms": [], "futs": []}
    dispatch, collect = eng._dispatch, eng._collect

    def timed_dispatch(*a, **kw):
        t0 = time.perf_counter()
        fut = dispatch(*a, **kw)
        rec["dispatch_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["futs"].append(fut)
        return fut

    def timed_collect(fut):
        t0 = time.perf_counter()
        out = collect(fut)
        rec["collect_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    eng._dispatch, eng._collect = timed_dispatch, timed_collect

    def restore():
        eng._dispatch, eng._collect = dispatch, collect

    return rec, restore


def recording_dispatch(eng, cells):
    """Wraps eng._dispatch to record each batch's layout cells (segment
    0's [(query indices, bq)]); returns the original to restore."""
    dispatch = eng._dispatch

    def recording(*a, **kw):
        fut = dispatch(*a, **kw)
        cells.append(fut[1][0])
        return fut

    eng._dispatch = recording
    return dispatch


def fused_bound(calls):
    """bound_ms of the fused kernel over one batch's buckets: each real
    posting's doc and value (8 B), the four plan tables (and the doc
    limits) and the outputs move once through device memory; the two f32
    multiplies per posting at the card's f32 rate. The dv layout computes
    the same function over the same postings, so it is counted the same
    way: its padding lanes are the layout's cost, not the function's.
    Returns (bound_ms, bound_by, postings)."""
    import torch

    bytes_, post = 0, 0
    for _seg, tabs, p, dlim, _dv in calls:
        sr, rm = tabs[0], tabs[1]
        # real postings the plan reads; skipped blocks read none
        valid = torch.where(sr >= 0, rm.clamp(0, p["block"]),
                            torch.zeros_like(rm))
        n_valid = int(valid.sum())
        post += n_valid
        bytes_ += n_valid * 8
        bytes_ += 4 * sr.numel() * 4 + sr.shape[0] * p["k"] * 8
        if dlim is not None:
            bytes_ += dlim.numel() * 4
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = 2 * post / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", post)


def tiled_bound(calls):
    """bound_ms of the tiled kernels over buckets: the demand that
    tools/roofline.py tiled_account counts for each (its real pairs, from
    the plan tables' runs; the plan tables, the chunks' survivors and the
    output) at the card's peaks (roofline.peaks). Returns (bound_ms,
    bound_by: the resource of the largest bucket's bound)."""
    import torch

    from document_search_engine_tpu_torch.ops import tiled as T
    from document_search_engine_tpu_torch.tools import roofline as R

    pk = R.peaks(torch.device("cuda"))
    accs = []
    for _seg, tabs, p, _dl, _dv in calls:
        runs = T.tiled_runs(*(t.cpu().numpy() for t in tabs),
                            block=p["block"], r_c=p["r_c"])
        accs.append(R.tiled_account(
            sum(int(r["off"][-1]) for r in runs), int(tabs[0].shape[0]),
            p["n_blocks"], p["block"], p["r_c"], p["s"], p["n_docs"],
            p["k"], pk))
    return (sum(a["bound_ms"] for a in accs),
            max(accs, key=lambda a: a["bound_ms"])["bound_by"])


def rank_bound(packed, k):
    """bound_ms of the rank-only kernel over one batch's buckets: the
    packed (nq, C) int32 doc keys and contributions read once and the
    (nq, k) outputs written once; one int32 add per candidate (the run
    sums) at the f32 CUDA-core rate (the peak table has no int32 row).
    Returns (bound_ms, bound_by, candidates)."""
    cand = sum(int(d.numel()) for d, _ci, _p in packed)
    rows = sum(int(d.shape[0]) for d, _ci, _p in packed)
    t_bytes = (cand * 8 + rows * k * 8) / HBM_BYTES_PER_S
    t_ops = cand / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", cand)


def capture_batch(eng, batch, k):
    """Runs one batch through eng and returns its _batch_step's
    arguments ({"args", "kw"}). On the card the engine replays the
    step's graph and calls no _batch_step, so they come from its record
    of the batch's step (eng._last_step: the _batch_step partial and
    the host inputs, put on the card here)."""
    import torch

    eng._collect(dispatch(eng, batch, k))
    step, inputs = eng._last_step
    ins = [torch.from_numpy(a).to(eng.device) for a in inputs]
    kw = dict(step.keywords)
    if len(ins) == 3:
        kw["cols_cat"] = ins[2]
    return {"args": (*step.args, ins[0], ins[1]), "kw": kw}


def dispatch(eng, batch, k):
    """eng._dispatch of one raw-text batch (either engine)."""
    stats = eng.stats if hasattr(eng, "segments") else eng.index.stats
    return eng._dispatch(eng.frontend.analyze_rows(batch, stats), k)


def run_statistics(d_key, ci, granule, n_docs, chunk_elems=16 << 20):
    """Per query of packed (nq, C) buffers whose aligned granules are
    ascending with sentinel tails: (natural runs, real pairs), as the
    rank stage counts them (ops/rank.py natural_run_starts)."""
    import torch

    from document_search_engine_tpu_torch.ops.rank import natural_run_starts

    runs, real = [], []
    step = max(1, chunk_elems // d_key.shape[1])
    for lo in range(0, d_key.shape[0], step):
        d = d_key[lo : lo + step]
        words = (d.long() << 32) | ci[lo : lo + step].long()
        runs.append(natural_run_starts(words, granule, n_docs << 32).sum(1))
        real.append((d < n_docs).sum(1))
    return torch.cat(runs), torch.cat(real)


def bucket_report(shape, ms, reps, runs, real, c, sw):
    """One bucket's line of the per-bucket report: its kernel ms, its
    queries' natural runs and real pairs, and where their merge buffers
    lie (csrc/rank.cuh place_buffers; sw words of shared memory behind
    the launch's table)."""
    from document_search_engine_tpu_torch.ops import fused as F

    both = int((2 * real <= sw).sum())
    first = int((real <= sw).sum()) - both
    return {
        "bucket": shape, "kernel_ms": ms, "kernel_ms_reps": reps,
        "region": ("shared memory"
                   if c * 8 <= F._lib().dse_smem_region_bytes()
                   else "per query"),
        "buffers_shared_shared": both, "buffers_shared_workspace": first,
        "buffers_workspace_workspace": int(real.numel()) - both - first,
        "runs_max": int(runs.max()), "runs_mean": float(runs.float().mean()),
        "real_max": int(real.max()), "real_mean": float(real.float().mean()),
    }


def bucket_kernel(mode, call) -> str:
    """The KERNELS entry of the kernel that serves a captured bucket
    (bucket_calls) in the engine's scorer mode: the tiled kernels where
    ops/tiled.py tiled_route takes it, else the mode's kernel."""
    from document_search_engine_tpu_torch.ops import tiled as T

    if mode == "xla_rank":
        return "rank_only"
    _seg, _tabs, p, dlim, dv = call
    if T.tiled_route(mode=mode, k=p["k"], split=dlim is not None,
                     r_c=p["r_c"], n_blocks=p["n_blocks"], s=p["s"]):
        return "fused_tiled"
    if dv is not None:
        return "fused_search_dv"
    if dlim is not None:
        return "fused_search_split"
    return fused_name(p["k"])


def launch_report(mode, call, k):
    """A bucket's launch: its kernel (bucket_kernel), threads a block and
    resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor;
    not reported for the rank-only kernel)."""
    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops import tiled as T
    from document_search_engine_tpu_torch.ops.rank import THREADS

    kernel = bucket_kernel(mode, call)
    if kernel == "rank_only":
        return {"kernel": kernel, "threads": THREADS, "blocks_per_sm": None}
    _seg, _tabs, p, dlim, dv = call
    if kernel == "fused_tiled":
        return {"kernel": kernel, "threads": T.TILED_THREADS,
                "blocks_per_sm": T.tiled_blocks_per_sm(p["n_blocks"],
                                                       p["s"])}
    threads = F.launch_threads(p["r_c"])
    load = 2 if dv is not None else int(dlim is not None)
    return {"kernel": kernel, "threads": threads,
            "blocks_per_sm": F._lib().dse_fused_blocks_per_sm(
                load, threads, p["r_c"], p["n_blocks"])}


def time_batch_buckets(eng, batch, k, diffs, res, key):
    """One batch's buckets at k, captured from a dispatch in the
    engine's current mode: the path's kernels (the fused kernel, its dlim
    or dv load stage, the tiled kernels, or the rank-only kernel) against
    their plain version in full, each timed as the median of TIMED_REPS
    warm runs; the bound from the same inputs. `by_kernel` holds the
    same for each kernel's own buckets (bucket_kernel), whose
    comparisons go to diffs[kernel]: the kernels line's entries."""
    import torch

    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops.fused_dv import fused_search_dv
    from document_search_engine_tpu_torch.ops.packed import pack_tables
    from document_search_engine_tpu_torch.ops.rank import (
        rank_candidates_kernel,
    )

    calls = bucket_calls(capture_batch(eng, batch, k))
    out = {"k": k, "scorer": eng.scorer_mode, "split_rows": eng.split_rows}
    out["buckets"] = [
        [int(c[1][0].shape[0]), c[2]["n_blocks"], c[2]["block"], c[2]["r_c"]]
        for c in calls
    ]
    if eng.scorer_mode == "xla_rank":
        # the plain pack (on the path, timed apart), then the rank kernel
        # against packed.rank_candidates on the packed buffers
        def pack_all():
            return [(*pack_tables(s.post_doc, s.post_val, *t[:3],
                                  p["scale"], p["clip"], p["n_blocks"],
                                  p["block"], p["n_docs"]), p)
                    for s, t, p, _dl, _dv in calls]

        packed, out["pack_ms"], out["pack_ms_reps"] = timed(pack_all)
        out["max_workspace_bytes"] = max(
            (2 * d.numel() * 8 for d, _ci, _p in packed
             if d.shape[1] * 8 > F._lib().dse_smem_region_bytes()), default=0)

        def run_bucket(i):
            d, ci, p = packed[i]
            return rank_candidates_kernel(d, ci, 0, block=p["block"],
                                          s=p["s"], k=p["k"],
                                          n_docs=p["n_docs"])

        def plain_one(i):
            d, ci, p = packed[i]
            return rank_chunks(d, ci, p)

        def stats(i):
            d, ci, p = packed[i]
            c = d.shape[1]
            return (*run_statistics(d, ci, p["block"], p["n_docs"]), c,
                    smem_words(c // p["block"], c))

        def bound(idx):
            return rank_bound([packed[i] for i in idx], k)[:2]

        out["bound_ms"], out["bound_by"], out["candidates"] = rank_bound(
            packed, k)
    else:
        smem = F._lib().dse_smem_region_bytes()
        out["max_workspace_bytes"] = max(
            (2 * c[1][0].shape[0] * c[2]["r_c"] * 128 * 8 for c in calls
             if c[2]["r_c"] * 128 * 8 > smem), default=0)

        def run_bucket(i):
            s, t, p, dl, dv = calls[i]
            if dv is not None:
                return fused_search_dv(dv, *t, **p)
            return F.fused_search(s.post_doc, s.post_val, *t, dlim=dl, **p)

        def stats(i):
            # what the kernel stores: every posting of the plan, in runs
            # of one block (doc limits zero a contribution, not a pair)
            s, t, p, _dl, _dv = calls[i]
            nb, block = p["n_blocks"], p["block"]
            step = max(1, (16 << 20) // (nb * block))
            parts = [run_statistics(
                *pack_tables(s.post_doc, s.post_val,
                             *(x[lo : lo + step] for x in t[:3]), p["scale"],
                             p["clip"], nb, block, p["n_docs"]),
                block, p["n_docs"]) for lo in range(0, t[0].shape[0], step)]
            return (torch.cat([r for r, _n in parts]),
                    torch.cat([n for _r, n in parts]), p["r_c"] * 128,
                    F.buffer_words(p["r_c"], nb))

        def plain_one(i):
            return plain_chunks(*calls[i])

        def bound(idx):
            sub = [calls[i] for i in idx]
            if kernels[idx[0]] == "fused_tiled":
                return tiled_bound(sub)
            return fused_bound(sub)[:2]

        out["bound_ms"], out["bound_by"], out["real_postings"] = (
            fused_bound(calls))
    kernels = [bucket_kernel(eng.scorer_mode, c) for c in calls]

    def run_kernel(idx=range(len(calls))):
        return [run_bucket(i) for i in idx]

    def run_plain(idx=range(len(calls))):
        return [plain_one(i) for i in idx]

    got, out["kernel_ms"], out["kernel_ms_reps"] = timed(run_kernel)
    want, out["plain_ms"], out["plain_ms_reps"] = timed(run_plain)
    for i, ((gv, gd), (wv, wd)) in enumerate(zip(got, want)):
        diffs[kernels[i]].check(gv, wv, f"{key} bucket {i} vals")
        diffs[kernels[i]].check(gd, wd, f"{key} bucket {i} docs")
    del got, want
    out["by_kernel"] = {}
    for name in dict.fromkeys(kernels):
        idx = [i for i, n in enumerate(kernels) if n == name]
        _o, ms, _r = timed(lambda: run_kernel(idx))
        _o, plain_ms, _r = timed(lambda: run_plain(idx))
        bound_ms, bound_by = bound(idx)
        out["by_kernel"][name] = {"buckets": len(idx), "ms": ms,
                                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                                  "bound_by": bound_by}
    # where the kernel's time sits: each bucket alone, with its queries'
    # natural runs and real pairs
    out["per_bucket"] = []
    for i, shape in enumerate(out["buckets"]):
        _o, ms, reps = timed(lambda: run_bucket(i))
        out["per_bucket"].append(bucket_report(shape, ms, reps, *stats(i)))
        b = out["per_bucket"][-1]
        b.update(launch_report(eng.scorer_mode, calls[i], k))
        if b["kernel"] == "fused_tiled":
            # B1 on the same tables: bit for bit, and its time beside
            s, t, p, _dl, _dv = calls[i]
            tiled = run_bucket(i)
            b1, b["b1_ms"], _r = timed(lambda: F.launch_fused(
                (s.post_doc, s.post_val), *t, None, **p))
            for j, part in enumerate(("vals", "docs")):
                diffs["fused_tiled"].check(
                    tiled[j], b1[j], f"{key} bucket {i} tiled vs B1 {part}")
        log(f"{key} bucket [nq, n_blocks, block, r_c] {shape}: {ms:.3f} ms "
            f"({b['kernel']}; B1 {b.get('b1_ms')} ms), "
            f"{b['threads']} threads, {b['blocks_per_sm']} blocks an SM, "
            f"{b['region']}, runs max {b['runs_max']} mean "
            f"{b['runs_mean']:.2f}, real pairs max {b['real_max']} mean "
            f"{b['real_mean']:.0f}, buffers shared+shared "
            f"{b['buffers_shared_shared']}, shared+workspace "
            f"{b['buffers_shared_workspace']}, workspace "
            f"{b['buffers_workspace_workspace']}")
    log(f"{key}: one {len(batch)}-query batch at k={k}, {len(calls)} "
        f"buckets, median of {TIMED_REPS} warm runs: kernel "
        f"{out['kernel_ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, "
        f"bound {out['bound_ms']:.4f} ms, bit-identical; largest "
        f"workspace {out['max_workspace_bytes']} B; by kernel "
        f"{out['by_kernel']}")
    res[key] = out


def rank_chunks(d_key, ci, p, chunk_elems=64 << 20):
    """packed.rank_candidates over one bucket's packed buffers, in query
    chunks of ~64M elements."""
    import torch

    from document_search_engine_tpu_torch.ops.packed import rank_candidates

    step = max(1, chunk_elems // d_key.shape[1])
    parts = [rank_candidates(d_key[lo : lo + step], ci[lo : lo + step], 0,
                             p["s"], p["k"], p["n_docs"])
             for lo in range(0, d_key.shape[0], step)]
    return torch.cat([v for v, _g in parts]), torch.cat([g for _v, g in parts])


def build_bound(resident, triples) -> int:
    """The build gates' limit in bytes above the build's start: the
    index built, its uploaded triples and one chunk's workspace."""
    return resident + TRIPLE_BYTES * triples + BUILD_WORKSPACE_BYTES


def check_build_peak(what, peak_extra, resident, triples) -> int:
    """Fail the run when a build's peak above its start passes
    build_bound; returns the bound."""
    bound = build_bound(resident, triples)
    if peak_extra > bound:
        raise AssertionError(
            f"{what}: peak {peak_extra} B above the start > {bound} B "
            f"(resident {resident} B + {TRIPLE_BYTES} B x {triples} "
            f"triples + {BUILD_WORKSPACE_BYTES} B)")
    return bound


def build_stage_peaks(eng):
    """The device build's peak bytes by stage: build_segment_device once
    more on the analyzed docs that the engine's one segment keeps, with
    the peak reset around each of device_pack, device_align_planes and
    device_materialize_vals. Returns {stage: peak bytes above the
    stage's start (its inputs already resident)}."""
    import torch

    from document_search_engine_tpu_torch.index import builder

    host = eng.segments[0][0]
    analyzed = builder.AnalyzedDocs(hashes=host.doc_hashes,
                                    tfs=host.doc_tfs, doc_ptr=host.doc_ptr,
                                    dl=host.dl)
    names = ("device_pack", "device_align_planes", "device_materialize_vals")
    originals = {name: getattr(builder, name) for name in names}
    peaks = {}

    def staged(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            m0 = torch.cuda.memory_allocated()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() - m0
            return out
        return run

    for name, fn in originals.items():
        setattr(builder, name, staged(name, fn))
    try:
        builder.build_segment_device(analyzed, eng.config, eng.device)
    finally:
        for name, fn in originals.items():
            setattr(builder, name, fn)
    return peaks


def main_engine(device, res):
    """The main path's index (phase 4): the 1M-doc corpus built through
    SearchEngine.build (its build time, postings, resident bytes and peak
    bytes above the start into res, the peak gated by build_bound, then
    the peak of each build stage), and its N_BATCHES query batches.
    Returns (engine, batches, texts)."""
    import torch

    from document_search_engine_tpu_torch import (
        IndexConfig,
        ScoringConfig,
        SearchEngine,
        bench,
    )
    from document_search_engine_tpu_torch.analyze.hashing import TermHasher
    from document_search_engine_tpu_torch.index.builder import shape_bucket

    n_docs, nq, n_batches = N_DOCS, NQ, N_BATCHES
    t0 = time.perf_counter()
    tokens = bench.synth_tokens(VOCAB)
    texts = [t for b in bench.synth_text_batches(n_docs, VOCAB, MEAN_LEN,
                                                 125_000) for t in b]
    log(f"corpus: {n_docs} docs generated in "
        f"{time.perf_counter() - t0:.1f}s (not part of the build time)")
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    eng = SearchEngine(cfg, device=device)
    sync = torch.cuda.synchronize
    sync()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng.build(texts)
    sync()
    res["build_s"] = time.perf_counter() - t0
    res["build_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - m0
    host = eng.segments[0][0]
    res["postings"] = int(host.indptr[-1])
    res["nnz_cap"] = shape_bucket(res["postings"])
    res["resident_bytes"] = eng.resident_bytes()
    res["build_peak_bound_bytes"] = check_build_peak(
        "phase 4 build", res["build_peak_extra_bytes"],
        res["resident_bytes"], res["nnz_cap"])
    res["build_stage_peak_bytes"] = build_stage_peaks(eng)
    stages = ", ".join(f"{name} {b}"
                       for name, b in res["build_stage_peak_bytes"].items())
    log(f"build: {n_docs} docs, {res['postings']} postings, "
        f"{res['resident_bytes']} resident bytes in {res['build_s']:.1f}s; "
        f"peak {res['build_peak_extra_bytes']} B above the start (gate "
        f"{res['build_peak_bound_bytes']} B); stage peaks above each "
        f"stage's start: {stages} B")

    # query text over the vocabulary rows that made it into the index
    hashes = TermHasher().hash_tokens(list(tokens))
    vocab_h = eng.stats.vocab
    pos = np.minimum(np.searchsorted(vocab_h, hashes), len(vocab_h) - 1)
    found = vocab_h[pos] == hashes
    tokens_by_row = np.empty(len(vocab_h), dtype=object)
    tokens_by_row[pos[found]] = tokens[found]
    df_by_row = np.where(
        [t is not None for t in tokens_by_row], eng.stats.df, 0
    )
    batches, _avg = bench.make_batches(df_by_row, tokens_by_row, nq,
                                       TERMS_PER_QUERY, n_batches)
    return eng, batches, texts


def phase_main(device, diffs, sample=1024, seed=0):
    """Phase 4; returns (results, engine, query batches, the counted
    run's (ids, scores) per batch, the corpus texts)."""
    import torch

    from document_search_engine_tpu_torch.analyze import native
    from document_search_engine_tpu_torch.ops import fused as F

    n_docs, nq, n_batches, k, depth = N_DOCS, NQ, N_BATCHES, K, DEPTH
    res = {"n_docs": n_docs, "vocab": VOCAB, "nq": nq, "batches": n_batches,
           "k": k, "depth": depth,
           "native_analyzer": bool(native.available())}
    eng, batches, texts = main_engine(device, res)
    eng.preplan(batches, k=k)
    t0 = time.perf_counter()
    eng.warmup(queries=batches[0], k=k)  # builds the kernel library
    sync = torch.cuda.synchronize
    sync()
    res["warmup_s"] = time.perf_counter() - t0
    # the counted main-path run; cell membership recorded per batch
    rec, restore = host_timers(eng)
    F.fused_search.launches = 0
    F.fused_search.launches_large_k = 0
    F.fused_search.launches_tiled = 0
    t0 = time.perf_counter()
    outs = list(eng.search_stream(batches, k=k, depth=depth))
    sync()
    dt = time.perf_counter() - t0
    res["launches"] = F.fused_search.launches
    res["launches_large_k"] = F.fused_search.launches_large_k
    res["launches_tiled"] = F.fused_search.launches_tiled
    restore()
    cells = [f[1][0] for f in rec["futs"]]
    res["dispatch_ms"] = float(np.median(rec["dispatch_ms"]))
    res["collect_ms"] = float(np.median(rec["collect_ms"]))
    res["serving_qps_counted_pass"] = nq * n_batches / dt
    res["layout"] = eng.plan_cache.stats()
    log(f"search_stream: {nq * n_batches} queries in {dt:.3f}s = "
        f"{res['serving_qps_counted_pass']:.1f} q/s, {res['launches']} "
        f"kernel launches, {res['layout']}; median ms a batch on the "
        f"host: dispatch {res['dispatch_ms']:.2f}, collect "
        f"{res['collect_ms']:.2f}")
    if res["launches"] <= 0 or res["launches_tiled"] <= 0:
        raise AssertionError("the main path launched no fused_search kernel "
                             "or no tiled kernel")
    # the graphs' replays count what the eager step launches: one a
    # bucket and batch, of the fused kernel or the tiled kernels
    res["buckets"] = sum(len(c) for f in rec["futs"] for c in f[1])
    if res["launches"] + res["launches_tiled"] != res["buckets"]:
        raise AssertionError(
            f"{res['launches']} fused and {res['launches_tiled']} tiled "
            f"launches for {res['buckets']} buckets")
    # each pass is a short window that includes the depth-2 pipeline's
    # fill and drain: report the median and the spread over several
    qps = []
    for _ in range(SERVING_PASSES):
        t0 = time.perf_counter()
        for _ids, _sc in eng.search_stream(batches, k=k, depth=depth):
            pass
        sync()
        qps.append(nq * n_batches / (time.perf_counter() - t0))
    res["serving_qps"] = float(np.median(qps))
    res["serving_qps_passes"] = qps
    log(f"search_stream, {SERVING_PASSES} more passes: median "
        f"{res['serving_qps']:.1f} q/s, range {min(qps):.1f}..{max(qps):.1f}")
    graph_pool(eng, res)
    hits = sum(int((ids[:, 0] >= 0).sum()) for ids, _ in outs)
    if hits < nq * n_batches // 2:
        raise AssertionError(f"only {hits} queries found any document")

    # per batch: a seeded sample covering every cell vs the plain scorer
    rng = np.random.default_rng(seed)
    eng.scorer = "plain"
    n_cmp = 0
    for b, (batch, (ids, sc), cell_list) in enumerate(
        zip(batches, outs, cells)
    ):
        pick, n_live = sample_cells(rng, cell_list, nq, sample)
        for lo in range(0, len(pick), 256):
            sel = pick[lo : lo + 256]
            p_ids, p_sc = eng.search([batch[i] for i in sel], k=k)
            np.testing.assert_array_equal(ids[sel], p_ids, f"batch {b} ids")
            np.testing.assert_array_equal(sc[sel], p_sc, f"batch {b} scores")
        n_cmp += len(pick)
        log(f"batch {b}: {len(pick)} sampled queries over {n_live} "
            f"cells == plain scorer")
    eng.scorer = None
    res["sampled_compared"] = n_cmp

    # one batch's buckets at full size: kernel vs plain, timed
    time_batch_buckets(eng, batches[0], k, diffs, res,
                       "batch_k10")
    return res, eng, batches, outs, texts


def dots_bound(gids, nq, kc, dim):
    """bound_ms of the dots over one batch: each distinct candidate row
    (dim B) and its ssq (4 B), the gids, the query rows and both outputs
    move once through device memory; 2 * dim int8 operations per
    candidate at the card's int8 rate. Returns (bound_ms, bound_by)."""
    import torch

    rows = int(torch.unique(gids.clamp(min=0)).numel())
    bytes_ = rows * (dim + 4) + nq * kc * 4 + nq * dim + 2 * nq * kc * 4
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = 2 * nq * kc * dim / INT8_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", rows)


def phase_rerank(eng, batches, diffs, sample=1024, seed=1):
    """Phase 5: search_rerank at full size on phase 4's index. Returns
    (results, the counted run's (ids, rerank, lexical) per batch)."""
    import torch

    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops import rerank as R

    k, kk, dim, nq = RERANK_K, CANDIDATES, DIM, NQ
    n_batches = len(batches)
    res = {"k": k, "candidates": kk, "dim": dim, "nq": nq,
           "batches": n_batches}
    sync = torch.cuda.synchronize
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    sync()
    t0 = time.perf_counter()
    emb, ssq = eng._device_embeddings(dim)
    sync()
    res["emb_build_s"] = time.perf_counter() - t0
    res["emb_bytes"] = emb.numel() * emb.element_size() + ssq.numel() * 4
    res["emb_build_peak_extra_bytes"] = (
        torch.cuda.max_memory_allocated() - base_mem)
    log(f"device embeddings: {tuple(emb.shape)} int8 + ssq, "
        f"{res['emb_bytes']} B in {res['emb_build_s']:.3f}s (peak "
        f"{res['emb_build_peak_extra_bytes']} B above the index)")

    eng.preplan(batches, k=kk)
    eng.search_rerank(batches[0], k=k, dim=dim, candidates=kk)  # warm

    # the counted rerank-path run
    cells = []
    dispatch = recording_dispatch(eng, cells)
    F.fused_search.launches = 0
    F.fused_search.launches_large_k = 0
    R.gather_and_dot.launches = 0
    t0 = time.perf_counter()
    outs = [eng.search_rerank(b, k=k, dim=dim, candidates=kk)
            for b in batches]
    sync()
    dt = time.perf_counter() - t0
    eng._dispatch = dispatch
    res["launches_small_k"] = F.fused_search.launches
    res["launches_large_k"] = F.fused_search.launches_large_k
    res["dots_launches"] = R.gather_and_dot.launches
    res["rerank_qps_counted_pass"] = nq * n_batches / dt
    log(f"search_rerank: {nq * n_batches} queries in {dt:.3f}s = "
        f"{res['rerank_qps_counted_pass']:.1f} q/s; launches: large-k "
        f"{res['launches_large_k']}, k<=16 {res['launches_small_k']}, "
        f"dots {res['dots_launches']}")
    if res["launches_large_k"] <= 0 or res["dots_launches"] <= 0:
        raise AssertionError("the rerank path did not launch both kernels")
    qps = []
    for _ in range(SERVING_PASSES):
        t0 = time.perf_counter()
        for b in batches:
            eng.search_rerank(b, k=k, dim=dim, candidates=kk)
        sync()
        qps.append(nq * n_batches / (time.perf_counter() - t0))
    res["rerank_qps"] = float(np.median(qps))
    res["rerank_qps_passes"] = qps
    log(f"search_rerank, {SERVING_PASSES} more passes: median "
        f"{res['rerank_qps']:.1f} q/s, range {min(qps):.1f}..{max(qps):.1f}")
    hits = sum(int((ids[:, 0] >= 0).sum()) for ids, _r, _l in outs)
    if hits < nq * n_batches // 2:
        raise AssertionError(f"only {hits} reranked queries found any doc")
    for ids, ri, lex in outs:
        if ids.shape != (nq, k) or ri.shape != (nq, k) or lex.shape != (nq, k):
            raise AssertionError(f"rerank output shape {ids.shape}")

    # per batch: a sample covering every cell vs plain scorer + plain dots
    rng = np.random.default_rng(seed)
    eng.scorer = "plain"
    kernel_dots = R.gather_and_dot
    R.gather_and_dot = R.gather_and_dot_plain
    n_cmp = 0
    try:
        for b, (batch, got, cell_list) in enumerate(zip(batches, outs, cells)):
            pick, n_live = sample_cells(rng, cell_list, nq, sample)
            for lo in range(0, len(pick), 256):
                sel = pick[lo : lo + 256]
                want = eng.search_rerank([batch[i] for i in sel], k=k,
                                         dim=dim, candidates=kk)
                for g, w, name in zip(got, want, ("ids", "rerank", "lex")):
                    np.testing.assert_array_equal(g[sel], w,
                                                  f"batch {b} {name}")
            n_cmp += len(pick)
            log(f"rerank batch {b}: {len(pick)} sampled queries over "
                f"{n_live} cells == plain scorer + plain dots")
    finally:
        R.gather_and_dot = kernel_dots
        eng.scorer = None
    res["sampled_compared"] = n_cmp

    # one batch's buckets at k = candidates: large-k kernel vs plain
    time_batch_buckets(eng, batches[0], kk, diffs,
                       res, "batch_k64")

    # where a batch's time goes: search_rerank's stages, one batch at a
    # time on the host clock (device stages end in their D2H read)
    dev = eng.device
    stages = {n: [] for n in ("analyze", "lexical", "query_emb",
                              "dots_and_d2h", "order")}
    for b in batches:
        t0 = time.perf_counter()
        analysis = eng.frontend.analyze_rows(b, eng.stats)
        slot_h, coeff = analysis[0], analysis[1]
        t1 = time.perf_counter()
        gids, lex = eng._collect(eng._dispatch(analysis, kk))
        t2 = time.perf_counter()
        qemb_h, ssq_q = R.query_embeddings_int(slot_h, coeff, dim)
        t3 = time.perf_counter()
        d, cs = R.gather_and_dot(
            emb, ssq, torch.from_numpy(qemb_h).to(dev),
            torch.from_numpy(gids.astype(np.int32)).to(dev))
        d, cs = d.cpu().numpy(), cs.cpu().numpy()
        t4 = time.perf_counter()
        R.rerank_order_int(d, ssq_q, cs, lex, gids, k)
        t5 = time.perf_counter()
        for name, dt_s in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                       t5 - t4)):
            stages[name].append(dt_s * 1e3)
        if b is batches[0]:
            batch0 = (qemb_h, gids)
    res["stage_ms"] = {n: float(np.median(v)) for n, v in stages.items()}
    log("search_rerank stages, median ms per batch: " + ", ".join(
        f"{n} {v:.2f}" for n, v in res["stage_ms"].items()))

    # one batch's dots, each a run of launches between one pair of CUDA
    # events: the kernel with the L2 warm (the batch's rows from the call
    # before) and cold (a 128 MiB write before each call, as
    # search_rerank finds the cache after the lexical kernel); the plain
    # version; and two PyTorch yardsticks the port never calls: one
    # float32 torch.bmm over rows gathered beforehand (the bmm alone),
    # and the whole function in PyTorch (the gather emb[gids], .float()
    # and the bmm)
    qemb = torch.from_numpy(batch0[0]).to(dev)
    g32 = torch.from_numpy(batch0[1].astype(np.int32)).to(dev)
    run = lambda: R.gather_and_dot(emb, ssq, qemb, g32)
    got = run()
    want = R.gather_and_dot_plain(emb, ssq, qemb, g32)
    diffs["rerank_dots"].check(got[0], want[0], "batch dots")
    diffs["rerank_dots"].check(got[1], want[1], "batch cand_ssq")
    res["dots_ms"], res["dots_ms_reps"] = loop_ms(run, 50)
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    res["dots_cold_ms"], res["dots_cold_ms_reps"] = loop_ms(
        run, 20, scratch=scratch)
    del scratch
    _o, res["dots_single_launch_ms"], _r = timed(run)
    # the same launch with every gid folded into the table's first 65,536
    # rows (16 MiB, which the L2 holds): as many row reads, none of them
    # from device memory once warm
    g_l2 = (g32.clamp(min=0) % 65536).to(torch.int32)
    res["dots_l2_resident_ms"], res["dots_l2_resident_ms_reps"] = loop_ms(
        lambda: R.gather_and_dot(emb, ssq, qemb, g_l2), 50)
    res["dots_plain_ms"], res["dots_plain_ms_reps"] = loop_ms(
        lambda: R.gather_and_dot_plain(emb, ssq, qemb, g32), 5)
    # every dot is an integer under 2^24, so full-f32 bmm is exact on
    # the gathered rows (TF32 is off)
    torch.backends.cuda.matmul.allow_tf32 = False
    safe = g32.clamp(min=0).long()
    cand_f = emb[safe].float()  # (nq, K, dim)
    q_f = qemb.float()[:, :, None]  # (nq, dim, 1)
    res["dots_library_equal"] = bool(
        (torch.bmm(cand_f, q_f)[:, :, 0].to(torch.int32) == got[0]).all())
    res["dots_library_ms"], res["dots_library_ms_reps"] = loop_ms(
        lambda: torch.bmm(cand_f, q_f), 20)
    del cand_f
    res["dots_gather_bmm_ms"], res["dots_gather_bmm_ms_reps"] = loop_ms(
        lambda: torch.bmm(emb[safe].float(), q_f), 10)
    res["dots_bound_ms"], res["dots_bound_by"], res["dots_rows"] = (
        dots_bound(g32, nq, kk, dim))
    log(f"one batch's dots ({nq} x {kk} x {dim}): kernel "
        f"{res['dots_ms']:.4f} ms L2-warm, {res['dots_cold_ms']:.4f} ms "
        f"L2-cold ({res['dots_single_launch_ms']:.4f} ms one launch, "
        f"{res['dots_l2_resident_ms']:.4f} ms with the rows in L2), "
        f"plain {res['dots_plain_ms']:.3f} ms, bmm "
        f"{res['dots_library_ms']:.3f} ms (equal: "
        f"{res['dots_library_equal']}), gather + bmm "
        f"{res['dots_gather_bmm_ms']:.3f} ms, bound "
        f"{res['dots_bound_ms']:.4f} ms ({res['dots_rows']} distinct rows)")
    return res, outs


def path_launches(name):
    """The launch count of the kernel serving a phase 6 path."""
    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops.rank import rank_kernel

    return {
        "rank_only": lambda: rank_kernel.launches,
        "fused_search_dv": lambda: F.fused_search.launches_dv,
        "fused_search_split": lambda: F.fused_search.launches_dlim,
    }[name]()


def reset_launches():
    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops.rank import rank_kernel
    from document_search_engine_tpu_torch.ops.segment_merge import (
        segment_merge,
    )

    for attr in ("launches", "launches_large_k", "launches_dlim",
                 "launches_dv", "launches_tiled"):
        setattr(F.fused_search, attr, 0)
    rank_kernel.launches = 0
    segment_merge.launches = 0


def phase_paths(eng, batches, base_outs, diffs):
    """Phase 6: the xla_rank, fused_dv and split paths at full size on
    phase 4's index; each must return phase 4's fused outputs for every
    query."""
    import torch

    sync = torch.cuda.synchronize
    k, depth, nq = K, DEPTH, NQ
    res = {}
    for scorer, split, name in PATHS:
        eng.scorer, eng.split_rows = scorer, split
        r = {"scorer": scorer, "split_rows": split}
        eng.preplan(batches, k=k)
        t0 = time.perf_counter()
        eng.warmup(queries=batches[0], k=k)
        sync()
        r["warmup_s"] = time.perf_counter() - t0
        if scorer == "fused_dv":
            r["dv_plane_bytes"] = sum(p.numel() * p.element_size()
                                      for p in eng._dv_planes())
        # the counted run: pieces and host times recorded per batch
        rec, restore = host_timers(eng)
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        outs = list(eng.search_stream(batches, k=k, depth=depth))
        sync()
        dt = time.perf_counter() - t0
        restore()
        r["launches"] = path_launches(name)
        r["dispatch_ms"] = float(np.median(rec["dispatch_ms"]))
        r["collect_ms"] = float(np.median(rec["collect_ms"]))
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        r["peak_extra_bytes"] = r["peak_bytes"] - base_mem
        r["serving_qps_counted_pass"] = nq * len(batches) / dt
        r["layout"] = eng.plan_cache.stats()
        if split is not None:
            pms = [f[2][0] for f in rec["futs"]]
            r["pieces_per_batch"] = [nq if pm is None else int(pm[3])
                                     for pm in pms]
            r["max_pieces_per_query"] = max(
                1 if pm is None else int(pm[2]) for pm in pms)
        if r["launches"] <= 0:
            raise AssertionError(f"the {scorer} path launched no {name}")
        assert_outs_equal(outs, base_outs, name)
        log(f"{name}: search_stream {nq * len(batches)} queries in "
            f"{dt:.3f}s = {r['serving_qps_counted_pass']:.1f} q/s, "
            f"median ms a batch on the host: dispatch {r['dispatch_ms']:.2f}"
            f", collect {r['collect_ms']:.2f}; "
            f"{r['launches']} launches, peak {r['peak_bytes']} B "
            f"({r['peak_extra_bytes']} B above the start), all ids and "
            f"scores == phase 4's")
        qps = []
        for _ in range(SERVING_PASSES):
            t0 = time.perf_counter()
            for _ids, _sc in eng.search_stream(batches, k=k, depth=depth):
                pass
            sync()
            qps.append(nq * len(batches) / (time.perf_counter() - t0))
        r["serving_qps"] = float(np.median(qps))
        r["serving_qps_passes"] = qps
        log(f"{name}: {SERVING_PASSES} more passes: median "
            f"{r['serving_qps']:.1f} q/s, range {min(qps):.1f}.."
            f"{max(qps):.1f}")
        time_batch_buckets(eng, batches[0], k, diffs, r, "batch")
        if scorer == "fused":
            # buckets that are still given a workspace
            r["workspace_buckets"] = sum(
                1 for b in r["batch"]["per_bucket"]
                if b["region"] == "per query")
        res[name] = r
    eng.scorer, eng.split_rows = None, None
    return res


# ------------------------------------------------------------ graphs
# the paths whose step graphs the bit gate holds against the eager step,
# on phase 4's index and batches: (scorer, split_rows, k)
GRAPH_PATHS = (
    ("fused", None, K), ("fused", None, 64), ("fused_dv", None, K),
    ("xla_rank", None, K), ("fused", 128, K),
)
SLEEP_MS = 50  # the no-wait gate's sleep on the stream, at least


def graph_bits(eng, batches, k, what):
    """Gate 1 of phase graphs for one path: every batch's key seen
    (warm passes until one captures nothing), then all the batches
    dispatched through their graphs at once (depth 8 holds the 4 of
    them in flight), and each output, held until the last is
    dispatched, equal bit for bit to the eager step called directly on
    the same inputs (eng._last_step)."""
    import torch

    g = eng._graphs
    if g is None:
        raise AssertionError(f"{what}: the engine keeps no step graphs")
    for _ in range(3):
        c0 = g.captures
        for b in batches:
            eng._collect(dispatch(eng, b, k))
        if g.captures == c0:
            break
    else:
        raise AssertionError(f"{what}: still capturing after 3 passes")
    r0, c0 = g.replays, g.captures
    futs, steps = [], []
    for b in batches:
        futs.append(dispatch(eng, b, k))
        steps.append(eng._last_step)
    if g.replays - r0 != len(batches) or g.captures != c0:
        raise AssertionError(
            f"{what}: {g.replays - r0} replays and {g.captures - c0} "
            f"captures for {len(batches)} warm batches")
    for i, (fut, (step, inputs)) in enumerate(zip(futs, steps)):
        want = step(*[torch.from_numpy(a).to(g.device) for a in inputs])
        if not torch.equal(fut[0], want):
            raise AssertionError(
                f"{what}: batch {i}: the graph's output differs from the "
                "eager step's")
        eng._collect(fut)
    return {"replays": len(batches), "graphs": len(g),
            "captures": g.captures}


def tiled_vs_b1(eng, batches, k, what):
    """The tiled kernels against the fused kernel (B1) under the step
    graphs: the batches through their graphs (warm, as graph_bits left
    them), each output equal bit for bit to the eager step run with
    every bucket on B1 (ops/fused.py TILED_MIN_RC past any r_c). Returns
    the tiled launches the replays counted."""
    import torch

    from document_search_engine_tpu_torch.ops import fused as F

    g = eng._graphs
    t0 = F.fused_search.launches_tiled
    futs, steps = [], []
    for b in batches:
        futs.append(dispatch(eng, b, k))
        steps.append(eng._last_step)
    tiled = F.fused_search.launches_tiled - t0
    saved = F.TILED_MIN_RC
    F.TILED_MIN_RC = 1 << 30
    try:
        for i, (fut, (step, inputs)) in enumerate(zip(futs, steps)):
            want = step(*[torch.from_numpy(a).to(g.device) for a in inputs])
            if not torch.equal(fut[0], want):
                raise AssertionError(
                    f"{what}: batch {i}: the graph's output (tiled kernels) "
                    "differs from the eager step on B1")
            eng._collect(fut)
    finally:
        F.TILED_MIN_RC = saved
    return {"tiled_launches": tiled}


def sleep_cycles_per_ms():
    """torch.cuda._sleep's cycles a millisecond on this card (events
    around one long sleep)."""
    import torch

    torch.cuda._sleep(1000)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    torch.cuda._sleep(10**7)
    ev1.record()
    torch.cuda.synchronize()
    return 1e7 / ev0.elapsed_time(ev1)


def graph_no_wait(eng, batch, k, what, cycles_per_ms):
    """Gate 2 of phase graphs: with a sleep of max(SLEEP_MS, 4 x a warm
    dispatch) enqueued on the stream, a warm _dispatch must return while
    the stream is still busy."""
    import torch

    eng._collect(dispatch(eng, batch, k))
    t0 = time.perf_counter()
    fut = dispatch(eng, batch, k)
    warm_ms = (time.perf_counter() - t0) * 1e3
    eng._collect(fut)
    sleep_ms = max(SLEEP_MS, 4 * warm_ms)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
    t0 = time.perf_counter()
    fut = dispatch(eng, batch, k)
    ms = (time.perf_counter() - t0) * 1e3
    busy = not torch.cuda.current_stream().query()
    eng._collect(fut)
    if not busy:
        raise AssertionError(
            f"{what}: _dispatch returned ({ms:.2f} ms) after the stream "
            f"drained a {sleep_ms:.1f} ms sleep: it waited on the card")
    return {"sleep_ms": sleep_ms, "dispatch_ms": ms}


def graph_pool(eng, res):
    """Gate 3 of phase graphs, after phase 4's serving: the engine's
    graph pool bytes may not exceed its graphs times the eager step's
    peak above its start on the last batch's inputs. Both sides are a
    private pool's segments (the eager step's run in a fresh
    torch.cuda.MemPool), so the allocator's rounding counts alike; the
    eager step's allocated peak is logged beside them."""
    import torch

    from document_search_engine_tpu_torch.engine.step_graph import (
        pool_bytes,
    )

    g = eng._graphs
    step, inputs = eng._last_step
    ins = [torch.from_numpy(a).to(g.device) for a in inputs]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    fresh = torch.cuda.MemPool()
    with torch.cuda.use_mem_pool(fresh):
        out = step(*ins)
        torch.cuda.synchronize()
        res["eager_step_pool_bytes"] = pool_bytes(fresh.id, g.device)
    res["eager_step_peak_bytes"] = torch.cuda.max_memory_allocated() - m0
    del out, ins, fresh
    res["graphs"] = len(g)
    res["graph_pool_bytes"] = g.pool_bytes()
    bound = len(g) * res["eager_step_pool_bytes"]
    if res["graph_pool_bytes"] > bound:
        raise AssertionError(
            f"graph pool {res['graph_pool_bytes']} B > {len(g)} graphs x "
            f"the eager step's {res['eager_step_pool_bytes']} B")
    log(f"graphs: {len(g)} after phase 4's serving, pool "
        f"{res['graph_pool_bytes']} B <= {len(g)} x the eager step's "
        f"{res['eager_step_pool_bytes']} B above its start (allocated "
        f"peak {res['eager_step_peak_bytes']} B)")


def dispatch_split(eng, batches, k):
    """Host ms a warm _dispatch spends planning and enqueueing
    (prof.phase dispatch.plan, dispatch.enqueue), the median of one
    dispatch of each batch, and the same enqueue run eagerly on the last
    batch (pinned staging, non-blocking copies, the eager step; host
    clock, no sync), the median of 3."""
    import torch

    from document_search_engine_tpu_torch.utils import prof

    plan, enq = [], []
    for b in batches:
        prof.reset()
        eng._collect(dispatch(eng, b, k))
        ph = json.loads(prof.metrics_json())["phases_s"]
        plan.append(ph["dispatch.plan"] * 1e3)
        enq.append(ph["dispatch.enqueue"] * 1e3)
    prof.reset()
    step, inputs = eng._last_step
    eager = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ins = [torch.from_numpy(a).pin_memory().to(eng._graphs.device,
                                                    non_blocking=True)
               for a in inputs]
        out = step(*ins)
        eager.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        del out, ins
    return {"plan_ms": float(np.median(plan)), "plan_ms_each": plan,
            "enqueue_ms": float(np.median(enq)), "enqueue_ms_each": enq,
            "eager_enqueue_ms": float(np.median(eager)),
            "eager_enqueue_ms_each": eager}


def phase_graphs(eng, batches):
    """Phase graphs on phase 4's engine and batches (after phase 6):
    for each of GRAPH_PATHS the bit gate (graph_bits); the no-wait gate
    (graph_no_wait) and the host's planning and enqueue a batch
    (dispatch_split) at phase 4's path. Phase 4 gated the pool
    (graph_pool); phase 8 adds the sharded engines' gates, main() the
    busy share and the bench's q/s. Returns the results."""
    res = {"paths": {}, "cycles_per_ms": sleep_cycles_per_ms()}
    for scorer, split, k in GRAPH_PATHS:
        what = f"{scorer} split {split} k {k}"
        eng.scorer, eng.split_rows = scorer, split
        eng.preplan(batches, k=k)
        res["paths"][what] = graph_bits(eng, batches, k, what)
        log(f"graphs, {what}: {len(batches)} batches in flight through "
            "their graphs == the eager step, bit for bit")
        if scorer == "fused" and split is None:
            res["paths"][what]["vs_b1"] = tiled_vs_b1(eng, batches, k, what)
            if res["paths"][what]["vs_b1"]["tiled_launches"] <= 0:
                raise AssertionError(f"{what}: no bucket took the tiled "
                                     "kernels")
            log(f"graphs, {what}: the graphs' tiled buckets == B1's eager "
                f"step, bit for bit, {res['paths'][what]['vs_b1']}")
    eng.scorer, eng.split_rows = None, None
    res["no_wait"] = graph_no_wait(eng, batches[0], K, "SearchEngine",
                                   res["cycles_per_ms"])
    res["dispatch"] = dispatch_split(eng, batches, K)
    g = eng._graphs
    res.update(captures=g.captures, replays=g.replays, graphs=len(g),
               capture_ms=list(g.capture_ms), pool_bytes=g.pool_bytes())
    d = res["dispatch"]
    log(f"graphs: a warm dispatch plans {d['plan_ms']:.2f} ms and "
        f"enqueues {d['enqueue_ms']:.3f} ms (eager enqueue "
        f"{d['eager_enqueue_ms']:.3f} ms); returned in "
        f"{res['no_wait']['dispatch_ms']:.2f} ms with a "
        f"{res['no_wait']['sleep_ms']:.1f} ms sleep still on the stream; "
        f"{g.captures} captures (median "
        f"{float(np.median(g.capture_ms)):.1f} ms), {len(g)} graphs, pool "
        f"{res['pool_bytes']} B")
    return res


# ------------------------------------------------------------ phase 7
def serve_all(eng, batches):
    """search_stream's (ids, scores) for every batch at the main path's
    k and depth."""
    return list(eng.search_stream(batches, k=K, depth=DEPTH))


def assert_outs_equal(got, want, what):
    assert len(got) == len(want), what
    for b, ((ids, sc), (w_ids, w_sc)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(ids, w_ids, f"{what}: batch {b} ids")
        np.testing.assert_array_equal(sc, w_sc, f"{what}: batch {b} scores")


def planes_equal(a, b):
    """Per plane: torch.equal of two one-segment engines' planes."""
    import torch

    da, db = a.segments[0][1], b.segments[0][1]
    return {f: bool(torch.equal(getattr(da, f), getattr(db, f)))
            for f in PLANES}


def cache_bytes(eng):
    """Device bytes of the engine's dv planes and doc-quantile tables."""
    return (sum(e[2].numel() * e[2].element_size()
                for e in eng._dv_cache.values())
            + sum(e[2].numel() * e[2].element_size()
                  for e in eng._quant_cache.values()))


HIT_LINE = r"^\s*(\d+)\. (\S+)  score=([0-9.]+)  \(doc (\d+)\)$"


def phase_cli(device, seed=13, shards=0):
    """Step 6 of phase 7 (and step 4 of phase 8, with `shards`): the CLI
    with its default device (the card, which must be `device`) on a
    small corpus written as files: index (`--shards N` when shards > 0),
    then search for each query and serve them all from a stdin stream;
    the printed hits must equal the library's on the saved index
    (SearchEngine.load, or DistributedSearchEngine.load for a sharded
    one) on the same queries."""
    import contextlib
    import io
    import re
    import tempfile

    from document_search_engine_tpu_torch import (
        DistributedSearchEngine,
        SearchEngine,
        cli,
    )
    from document_search_engine_tpu_torch.corpus.synth import (
        synth_corpus,
        synth_queries,
    )

    docs = synth_corpus(n_docs=CLI_DOCS, seed=seed)
    queries = synth_queries(docs, n_queries=CLI_QUERIES, seed=seed + 1)
    hit = re.compile(HIT_LINE)

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        if rc != 0:
            raise AssertionError(f"cli {argv[0]} returned {rc}")
        return out.getvalue()

    with tempfile.TemporaryDirectory() as d:
        corpus, idx = os.path.join(d, "corpus"), os.path.join(d, "idx")
        os.mkdir(corpus)
        for i, text in enumerate(docs):
            with open(os.path.join(corpus, f"doc_{i:05d}.txt"), "w") as f:
                f.write(text)
        t0 = time.perf_counter()
        extra = ["--shards", str(shards)] if shards else []
        info = json.loads(run(["index", corpus, "--out", idx] + extra))
        if info["docs"] != CLI_DOCS:
            raise AssertionError(f"cli index: {info}")
        with open(os.path.join(idx, "docnames.json")) as f:
            names = json.load(f)
        with open(os.path.join(idx, "meta.json")) as f:
            saved_shards = json.load(f).get("n_shards", 0)
        if saved_shards != shards:
            raise AssertionError(f"cli index saved {saved_shards} shards")
        if shards:
            lib = DistributedSearchEngine.load(idx)
            where = lib.mesh.dst
        else:
            lib = SearchEngine.load(idx)
            where = lib.device
        if where != device:
            raise AssertionError(f"the index opened on {where}")
        ids, scores = lib.search(queries, k=K)
        sb = lib.config.scoring.scale_bits
        n_hits = 0
        for qi, q in enumerate(queries):
            got = [hit.match(ln).groups()
                   for ln in run(["search", idx, q]).strip().splitlines()]
            want = [(str(r), names[g], f"{s / (1 << sb):.6f}", str(g))
                    for r, (g, s) in enumerate(zip(ids[qi], scores[qi]), 1)
                    if g >= 0]
            if got != want:
                raise AssertionError(f"cli search {q!r}: {got} != {want}")
            n_hits += len(got)
        stdin = sys.stdin
        sys.stdin = io.StringIO("\n".join(queries) + "\n")
        try:
            lines = run(["serve", idx, "--batch", "8"]).strip().splitlines()
        finally:
            sys.stdin = stdin
        if len(lines) != len(queries):
            raise AssertionError(f"cli serve: {len(lines)} lines")
        for qi, line in enumerate(lines):
            want = [{"doc": int(g), "score": float(s) / (1 << sb)}
                    for g, s in zip(ids[qi], scores[qi]) if g >= 0]
            if json.loads(line)["hits"] != want:
                raise AssertionError(f"cli serve, query {qi}: {line}")
        dt = time.perf_counter() - t0
    if n_hits == 0:
        raise AssertionError("the CLI's queries found nothing")
    return {"cli_docs": CLI_DOCS, "cli_queries": CLI_QUERIES,
            "cli_hits": n_hits, "cli_s": dt}


def deleted_ids(rng, n_docs):
    """The N_DELETE ids phase 7's delete tombstones (phase 8 deletes the
    same ones from its sharded engine)."""
    return rng.choice(n_docs, size=N_DELETE, replace=False)


def phase_lifecycle(eng, batches, base_outs, texts, sample=1024, seed=11):
    """Phase 7: the lifecycle at full size, on phase 4's corpus, index
    and query batches. Step 1, a streaming build of the corpus in 8
    batches, compacted by the default policy: its planes and results
    equal phase 4's. Step 2, one delete_docs of a seeded 10% on both
    engines: both give the same results, no deleted id comes back, and a
    sample equals the plain scorer. Step 3, with the dv planes and the
    doc-quantile tables filled (one batch through fused_dv and one split
    at 128, both equal to the fused results), a compact: the results stay
    and the device bytes it frees are the old planes, the dv planes and
    the quantile tables. Step 4, save and load (the card, by default):
    the same resident bytes, the same results, no layout grows. Step 6,
    the CLI on the card. The fused kernel must have launched (step 5)."""
    import tempfile

    import torch

    from document_search_engine_tpu_torch import SearchEngine
    from document_search_engine_tpu_torch.corpus.loader import stream_batches
    from document_search_engine_tpu_torch.index.builder import shape_bucket
    from document_search_engine_tpu_torch.ops import fused as F

    sync = torch.cuda.synchronize
    mem = torch.cuda.memory_allocated
    nq = NQ * len(batches)
    res = {"n_docs": len(texts), "stream_batch_docs": STREAM_BATCH_DOCS}
    reset_launches()

    # 1. the streaming build, its final compact timed apart
    seng = SearchEngine(eng.config, device=eng.device)
    compact_s = []

    def timed_compact(compact=seng.compact):
        sync()
        t0 = time.perf_counter()
        compact()
        sync()
        compact_s.append(time.perf_counter() - t0)

    seng.compact = timed_compact
    sync()
    torch.cuda.reset_peak_memory_stats()
    m0 = mem()
    t0 = time.perf_counter()
    seng.build_streaming(stream_batches(texts, STREAM_BATCH_DOCS))
    sync()
    res["streaming_build_s"] = time.perf_counter() - t0
    res["streaming_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - m0
    del seng.compact  # the method again
    if len(compact_s) != 1 or len(seng.segments) != 1:
        raise AssertionError(
            f"streaming build: {len(seng.segments)} segments after "
            f"{len(compact_s)} compactions")
    res["streaming_compact_s"] = compact_s[0]
    res["streaming_compact_share"] = compact_s[0] / res["streaming_build_s"]
    same = planes_equal(seng, eng)
    if not all(same.values()):
        raise AssertionError(f"streaming planes != phase 4's: {same}")
    assert_outs_equal(serve_all(seng, batches), base_outs,
                      "streaming build vs phase 4")
    # logged against the build gates' rule, not gated: the batches'
    # segments are all resident when the final compact builds
    res["streaming_peak_rule_bytes"] = build_bound(
        seng.resident_bytes(),
        shape_bucket(int(seng.segments[0][0].indptr[-1])))
    log(f"streaming build: {res['n_docs']} docs in 8 batches, "
        f"{res['streaming_build_s']:.2f}s ({compact_s[0]:.2f}s of it the "
        f"final compact), peak {res['streaming_peak_extra_bytes']} B above "
        f"the start (the build rule, not gated: "
        f"{res['streaming_peak_rule_bytes']} B); planes and all {nq} "
        f"results == phase 4's")

    # 2. one delete of 10%, on both engines
    rng = np.random.default_rng(seed)
    dead = deleted_ids(rng, len(texts))
    sync()
    t0 = time.perf_counter()
    seng.delete_docs(dead)
    sync()
    res["delete_s"] = time.perf_counter() - t0
    res["deleted"] = N_DELETE
    eng.delete_docs(dead)
    d_outs = serve_all(seng, batches)
    assert_outs_equal(serve_all(eng, batches), d_outs,
                      "delete: phase 4's engine vs the streaming one")
    if any(np.isin(ids, dead).any() for ids, _sc in d_outs):
        raise AssertionError("a deleted doc came back")
    res["queries_changed_by_delete"] = int(sum(
        (ids != w_ids).any(axis=1).sum()
        for (ids, _s), (w_ids, _w) in zip(d_outs, base_outs)))
    pick = np.sort(rng.choice(NQ, size=sample, replace=False))
    seng.scorer = "plain"
    for lo in range(0, sample, 256):
        sel = pick[lo : lo + 256]
        p_ids, p_sc = seng.search([batches[0][i] for i in sel], k=K)
        np.testing.assert_array_equal(d_outs[0][0][sel], p_ids,
                                      "delete: plain ids")
        np.testing.assert_array_equal(d_outs[0][1][sel], p_sc,
                                      "delete: plain scores")
    log(f"delete: {N_DELETE} docs in {res['delete_s']:.3f}s (host and "
        f"refresh); both engines equal on all {nq} queries "
        f"({res['queries_changed_by_delete']} changed), no deleted id "
        f"returned, {sample} sampled == plain scorer")

    # 3. fill the dv and quantile caches, then compact
    for scorer, split in (("fused_dv", None), ("fused", 128)):
        seng.scorer, seng.split_rows = scorer, split
        ids, sc = seng.search(batches[0], k=K)
        np.testing.assert_array_equal(ids, d_outs[0][0], f"{scorer} ids")
        np.testing.assert_array_equal(sc, d_outs[0][1], f"{scorer} scores")
    seng.scorer, seng.split_rows = None, None
    res["cache_bytes_before_compact"] = cache_bytes(seng)
    if not (seng._dv_cache and seng._quant_cache):
        raise AssertionError("the dv and quantile caches were not filled")
    sync()
    a, r0 = mem(), seng.resident_bytes()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seng.compact()
    sync()
    res["compact_s"] = time.perf_counter() - t0
    b, r1 = mem(), seng.resident_bytes()
    res["compact_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - a
    res.update(compact_allocated_before=a, compact_allocated_after=b,
               resident_before=r0, resident_after=r1)
    if b - a > (r1 - r0) + 0.05 * r1:
        raise AssertionError(
            f"compact freed too little: allocated {a} -> {b}, resident "
            f"{r0} -> {r1}")
    res["compact_peak_bound_bytes"] = check_build_peak(
        "phase 7 compact", res["compact_peak_extra_bytes"], r1,
        shape_bucket(int(seng.segments[0][0].indptr[-1])))
    seng.preplan(batches, k=K)
    c_outs = serve_all(seng, batches)
    assert_outs_equal(c_outs, d_outs, "compact")
    qps = []
    for _ in range(SERVING_PASSES):
        t0 = time.perf_counter()
        serve_all(seng, batches)
        sync()
        qps.append(nq / (time.perf_counter() - t0))
    res["serving_qps_after_compact"] = float(np.median(qps))
    res["serving_qps_after_compact_passes"] = qps
    log(f"compact: {res['compact_s']:.2f}s, peak "
        f"{res['compact_peak_extra_bytes']} B above the start (gate "
        f"{res['compact_peak_bound_bytes']} B); allocated "
        f"{a} -> {b} B, resident {r0} -> {r1} B (dv planes and quantile "
        f"tables held {res['cache_bytes_before_compact']} B); all results "
        f"unchanged; serving after it: median "
        f"{res['serving_qps_after_compact']:.1f} q/s")

    # 4. save and load, on the card by default
    with tempfile.TemporaryDirectory() as d:
        sync()
        t0 = time.perf_counter()
        seng.save(d)
        res["save_s"] = time.perf_counter() - t0
        res["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        t0 = time.perf_counter()
        leng = SearchEngine.load(d)
        sync()
        res["load_s"] = time.perf_counter() - t0
    if leng.device != eng.device:
        raise AssertionError(f"SearchEngine.load opened on {leng.device}")
    if leng.resident_bytes() != seng.resident_bytes():
        raise AssertionError("the loaded index holds other bytes")
    assert_outs_equal(serve_all(leng, batches), c_outs, "loaded checkpoint")
    res["loaded_layout"] = leng.plan_cache.stats()
    if leng.plan_cache.grows != 0:
        raise AssertionError(f"replay grew layouts: {res['loaded_layout']}")
    del leng
    log(f"save {res['save_s']:.2f}s ({res['checkpoint_bytes']} B on disk), "
        f"load {res['load_s']:.2f}s; all results == the saved engine's, "
        f"{res['loaded_layout']}")

    # 6. the CLI on the card (a small corpus of its own)
    res.update(phase_cli(eng.device))
    log(f"cli: index, {CLI_QUERIES} searches and serve on the card in "
        f"{res['cli_s']:.2f}s, {res['cli_hits']} hits == the library's")

    # 5. the kernels ran over the whole phase
    res["launches"] = F.fused_search.launches
    res["launches_dv"] = F.fused_search.launches_dv
    res["launches_dlim"] = F.fused_search.launches_dlim
    for key in ("launches", "launches_dv", "launches_dlim"):
        if res[key] <= 0:
            raise AssertionError(f"phase 7: no fused_search {key}")
    return res


# ------------------------------------------------------------ phase 8
def serve_timed(eng, batches, passes):
    """Median q/s of `passes` search_stream passes over the batches
    (host clock ending in a sync), and each pass's q/s."""
    import torch

    qps = []
    for _ in range(passes):
        t0 = time.perf_counter()
        serve_all(eng, batches)
        torch.cuda.synchronize()
        qps.append(NQ * len(batches) / (time.perf_counter() - t0))
    return float(np.median(qps)), qps


def counted_pass(eng, batches, k=K):
    """One search_stream pass with the launch counts set to 0 just
    before it and the host's dispatch/collect ms recorded. Returns (outs,
    the counts read just after, host record, seconds)."""
    import torch

    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops.rank import rank_kernel

    rec, restore = host_timers(eng)
    reset_launches()
    t0 = time.perf_counter()
    outs = list(eng.search_stream(batches, k=k, depth=DEPTH))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    restore()
    counts = {
        "fused_search": F.fused_search.launches,
        "fused_search_large_k": F.fused_search.launches_large_k,
        "fused_search_split": F.fused_search.launches_dlim,
        "fused_tiled": F.fused_search.launches_tiled,
        "rank_only": rank_kernel.launches,
    }
    return outs, counts, rec, dt


def timed_step(fn):
    """Seconds of fn() on the host clock, ending in a sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_sharded(eng, batches, base_outs, rerank_outs, texts,
                  cycles_per_ms, seed=11):
    """Phase 8: the sharded engine at full size, on phase 4's corpus and
    query batches, every shard on the one card. Step 1, for each of
    SHARD_COUNTS: a DistributedSearchEngine built from the corpus whose
    results equal phase 4's on all queries; the fused kernel launched
    once per shard and bucket. Step 2, at SHARDED_AT shards: scorer
    xla_rank, split_rows 128 and a host build (its value planes equal
    to the device build's) equal phase 4's results, and search_rerank
    equals phase 5's single-engine rerank. Step 3, the lifecycle at
    SHARDED_AT shards beside phase 4's engine (which phase 7 left with
    the same delete): the delete of phase 7's ids, an add of N_ADD new
    docs and a compact, equal to the single engine after each; a save
    and a load on RESHARD_TO shards, equal to the saved engine. Step 4,
    the CLI's index --shards 2 and search on the card. Step 5: every
    kernel of the path launched."""
    import tempfile

    import torch

    from document_search_engine_tpu_torch import (
        DistributedSearchEngine,
        bench,
        make_mesh,
    )
    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops import rerank as R

    cfg = eng.config
    nq = NQ * len(batches)
    res = {"n_docs": len(texts), "shard_counts": list(SHARD_COUNTS),
           "per_shards": {}}
    launches = {}

    # 1. each shard count: build, results, serving, host ms a batch
    keep = None
    for n in SHARD_COUNTS:
        r = {}
        deng = DistributedSearchEngine(cfg, mesh=make_mesh(n))
        r["devices"] = sorted({str(d) for d in deng.mesh.devices})
        if any(d.type != eng.device.type for d in deng.mesh.devices):
            raise AssertionError(f"{deng.mesh}: not on {eng.device.type}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        _o, r["build_s"] = timed_step(lambda: deng.build(texts))
        r["build_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - m0
        r["resident_bytes"] = deng.resident_bytes()
        idx = deng.index
        r["triples"] = sum(int(h.indptr[-1]) for h in idx.hosts)
        r["build_peak_bound_bytes"] = check_build_peak(
            f"phase 8 build at {n} shards", r["build_peak_extra_bytes"],
            r["resident_bytes"], r["triples"])
        r.update(d_pad=idx.d_pad, t_pad=idx.t_pad, x_rows=idx.x_rows)
        deng.preplan(batches, k=K)
        _o, r["warmup_s"] = timed_step(
            lambda: deng.warmup(queries=batches[0], k=K))
        outs, counts, rec, dt = counted_pass(deng, batches)
        assert_outs_equal(outs, base_outs, f"{n} shards vs phase 4")
        buckets = [len(f[1]) for f in rec["futs"]]
        r["buckets_per_batch"] = buckets
        r["launches"] = counts["fused_search"]
        r["launches_tiled"] = counts["fused_tiled"]
        if r["launches"] + r["launches_tiled"] != n * sum(buckets):
            raise AssertionError(
                f"{n} shards: {r['launches']} fused and "
                f"{r['launches_tiled']} tiled launches, expected one per "
                f"shard and bucket ({n} x {sum(buckets)})")
        for name in ("fused_search", "fused_tiled"):
            launches[name] = launches.get(name, 0) + counts[name]
        r["dispatch_ms"] = float(np.median(rec["dispatch_ms"]))
        r["collect_ms"] = float(np.median(rec["collect_ms"]))
        r["serving_qps_counted_pass"] = nq / dt
        r["serving_qps"], r["serving_qps_passes"] = serve_timed(
            deng, batches, SHARDED_PASSES)
        r["graph_bits"] = graph_bits(deng, batches, K, f"{n} shards")
        # a shard's regions shrink with its share of the postings: at
        # several shards phase 4's queries may leave no bucket at
        # TILED_MIN_RC
        r["graph_bits"]["vs_b1"] = tiled_vs_b1(deng, batches, K,
                                               f"{n} shards")
        if n == 1 and r["graph_bits"]["vs_b1"]["tiled_launches"] <= 0:
            raise AssertionError("1 shard: no bucket took the tiled kernels")
        r["graph_no_wait"] = graph_no_wait(
            deng, batches[0], K, f"{n} shards", cycles_per_ms)
        r["graph_dispatch"] = dispatch_split(deng, batches, K)
        res["per_shards"][str(n)] = r
        log(f"{n} shards: build {r['build_s']:.2f}s (peak "
            f"{r['build_peak_extra_bytes']} B above the start, gate "
            f"{r['build_peak_bound_bytes']} B), resident "
            f"{r['resident_bytes']} B (x_rows {idx.x_rows}, d_pad "
            f"{idx.d_pad}); all {nq} results == phase 4's; "
            f"{r['launches']} fused launches ({n} x {sum(buckets)} buckets)"
            f"; median {r['serving_qps']:.1f} q/s; host ms a batch: "
            f"dispatch {r['dispatch_ms']:.2f}, collect {r['collect_ms']:.2f}"
            f"; its {len(batches)} batches in flight == the eager step bit "
            f"for bit (and == B1's eager step: "
            f"{r['graph_bits']['vs_b1']['tiled_launches']} tiled launches)"
            f"; dispatch returned in "
            f"{r['graph_no_wait']['dispatch_ms']:.2f} ms with the stream "
            f"still busy; a warm dispatch plans "
            f"{r['graph_dispatch']['plan_ms']:.2f} ms, enqueues "
            f"{r['graph_dispatch']['enqueue_ms']:.3f} ms (eager "
            f"{r['graph_dispatch']['eager_enqueue_ms']:.3f} ms)")
        if n == SHARDED_AT:
            keep = deng
        del deng
    deng = keep

    # 2. the further paths and the rerank at SHARDED_AT shards
    for scorer, split, name in (("xla_rank", None, "rank_only"),
                                ("fused", 128, "fused_search_split")):
        deng.scorer, deng.split_rows = scorer, split
        deng.preplan(batches, k=K)
        deng.warmup(queries=batches[0], k=K)
        outs, counts, rec, dt = counted_pass(deng, batches)
        assert_outs_equal(outs, base_outs, f"{name} at {SHARDED_AT} shards")
        launches[name] = counts[name]
        res[name] = {"launches": counts[name], "qps_counted_pass": nq / dt,
                     "dispatch_ms": float(np.median(rec["dispatch_ms"])),
                     "collect_ms": float(np.median(rec["collect_ms"]))}
        log(f"{SHARDED_AT} shards, {name}: all {nq} results == phase 4's, "
            f"{counts[name]} launches, {nq / dt:.1f} q/s (counted pass)")
    deng.scorer, deng.split_rows = None, None

    heng = DistributedSearchEngine(cfg, mesh=make_mesh(SHARDED_AT))
    heng.device_build = False
    _o, res["host_build_s"] = timed_step(lambda: heng.build(texts))
    same = [bool(torch.equal(a, b))
            for a, b in zip(heng.index.post_val, deng.index.post_val)]
    if not all(same):
        raise AssertionError(f"host-built value planes differ: {same}")
    assert_outs_equal(serve_all(heng, batches), base_outs, "host build")
    del heng
    log(f"{SHARDED_AT} shards, host build: {res['host_build_s']:.2f}s; "
        f"value planes == the device build's; all {nq} results == phase 4's")

    rk, kk, dim = RERANK_K, CANDIDATES, DIM
    deng.preplan(batches, k=kk)
    deng.search_rerank(batches[0], k=rk, dim=dim, candidates=kk)  # warm
    reset_launches()
    R.gather_and_dot.launches = 0
    t0 = time.perf_counter()
    r_outs = [deng.search_rerank(b, k=rk, dim=dim, candidates=kk)
              for b in batches]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches["fused_search_large_k"] = F.fused_search.launches_large_k
    launches["rerank_dots"] = R.gather_and_dot.launches
    for b, (got, want) in enumerate(zip(r_outs, rerank_outs)):
        for g, w, what in zip(got, want, ("ids", "rerank", "lex")):
            np.testing.assert_array_equal(g, w, f"rerank batch {b} {what}")
    res["rerank"] = {"qps_counted_pass": nq / dt,
                     "launches_large_k": launches["fused_search_large_k"],
                     "dots_launches": launches["rerank_dots"]}
    log(f"{SHARDED_AT} shards, search_rerank: all {nq} results == phase "
        f"5's single engine; {nq / dt:.1f} q/s; launches large-k "
        f"{launches['fused_search_large_k']}, dots {launches['rerank_dots']}")

    # 3. the lifecycle beside phase 4's engine (phase 7 deleted the same
    # ids from it)
    dead = deleted_ids(np.random.default_rng(seed), len(texts))
    _o, res["delete_s"] = timed_step(lambda: deng.delete_docs(dead))
    want = serve_all(eng, batches)
    got = serve_all(deng, batches)
    assert_outs_equal(got, want, "sharded delete vs the single engine")
    if any(np.isin(ids, dead).any() for ids, _sc in got):
        raise AssertionError("a deleted doc came back")
    add_texts = bench.synth_text_batches(N_ADD, VOCAB, MEAN_LEN, N_ADD,
                                         seed=seed + 6)[0]
    idx_before = deng.index
    new_ids, res["add_s"] = timed_step(lambda: deng.add_docs(add_texts))
    # True: the add fit the padded shapes (_update_last_shard)
    res["add_in_place"] = deng.index is idx_before
    if new_ids != eng.add_docs(add_texts):
        raise AssertionError("add_docs gave other ids")
    assert_outs_equal(serve_all(deng, batches), serve_all(eng, batches),
                      "sharded add vs the single engine")
    _o, res["compact_s"] = timed_step(deng.compact)
    eng.compact()
    c_outs = serve_all(deng, batches)
    assert_outs_equal(c_outs, serve_all(eng, batches),
                      "sharded compact vs the single engine")
    res["resident_after_compact"] = deng.resident_bytes()
    with tempfile.TemporaryDirectory() as d:
        _o, res["save_s"] = timed_step(lambda: deng.save(d))
        res["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        leng, res["load_s"] = timed_step(lambda: DistributedSearchEngine.load(
            d, mesh=make_mesh(RESHARD_TO)))
    if leng.index.n_shards != RESHARD_TO:
        raise AssertionError(f"loaded on {leng.index.n_shards} shards")
    assert_outs_equal(serve_all(leng, batches), c_outs,
                      f"loaded on {RESHARD_TO} shards")
    del leng
    log(f"{SHARDED_AT} shards, lifecycle: delete {N_DELETE} "
        f"{res['delete_s']:.2f}s, add {N_ADD} {res['add_s']:.2f}s, compact "
        f"{res['compact_s']:.2f}s, save {res['save_s']:.2f}s "
        f"({res['checkpoint_bytes']} B on disk), load on {RESHARD_TO} "
        f"shards {res['load_s']:.2f}s; all {nq} results == the single "
        "engine's after each step, and the reloaded engine's == the saved")
    del deng

    # 4. the CLI's sharded index on the card
    # the default mesh's device: the card
    cli = phase_cli(make_mesh(1).dst, shards=2)
    res.update({f"sharded_{key}": v for key, v in cli.items()})
    log(f"cli: index --shards 2, {CLI_QUERIES} searches and serve on the "
        f"card in {cli['cli_s']:.2f}s, {cli['cli_hits']} hits == the "
        "library's")

    # 5. every kernel of the path launched
    res["launches"] = launches
    for name in ("fused_search", "fused_search_large_k",
                 "fused_search_split", "rank_only", "rerank_dots"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"phase 8: {name} never launched")
    return res


# ------------------------------------------------------------ phase 9
def pack_inputs(eng, batch):
    """One batch's packed-step inputs on a one-segment engine: the active
    slots' CSR rows and coefficients (0 for a term the index lacks), and
    the found mask (frontend.analyze, segment_rows; the engine trims the
    slots the same way)."""
    from document_search_engine_tpu_torch.engine.engine import (
        slice_active_slots,
    )
    from document_search_engine_tpu_torch.engine.query import segment_rows

    host = eng.segments[0][0]
    slot_h, coeff = eng.frontend.analyze(batch, eng.stats)
    slot_h, coeff = slice_active_slots(slot_h, coeff)
    rows, found = segment_rows(host.term_hash, slot_h)
    return rows, np.where(found, coeff, np.float32(0.0)), found


def pack_groups(eng, rows, found):
    """The batch's queries grouped by pow-2 n_blocks budget at PACK_BLOCK
    (schedule.bucket_queries over blocks_per_query), each group's budget
    from block_plan over its queries, and cut into chunks of at most
    PACK_CHUNK_ELEMS packed pairs. Returns [(indices, n_blocks,
    [chunk indices])]."""
    from document_search_engine_tpu_torch.ops.schedule import (
        block_plan,
        blocks_per_query,
        bucket_queries,
    )

    indptr = eng.segments[0][0].indptr
    nblk = blocks_per_query(indptr, rows, found, PACK_BLOCK)
    groups = []
    for idx, budget in bucket_queries(nblk, min_blocks=1):
        nb = block_plan(indptr, rows[idx], found[idx], block=PACK_BLOCK)
        if nb != budget:
            raise AssertionError(f"block_plan {nb} != bucket {budget}")
        step = max(1, PACK_CHUNK_ELEMS // (nb * PACK_BLOCK))
        groups.append((idx, nb, [idx[lo : lo + step]
                                  for lo in range(0, len(idx), step)]))
    return groups


def pack_chunk(eng, rows_t, coeff_t, n_blocks):
    """pack_ds of one chunk on the engine's planes: (d_key, ci)."""
    from document_search_engine_tpu_torch.ops.packed import pack_ds

    host, seg = eng.segments[0]
    return pack_ds(seg.post_doc, seg.post_val, seg.indptr, seg.row_start,
                   rows_t, coeff_t, SCALE, CLIP, n_blocks=n_blocks,
                   n_docs=host.n_docs, block=PACK_BLOCK)


def union_ms(intervals):
    """Length of the union of [start, end) intervals (trace µs), in ms."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def phase_packed(eng, batches, base_outs, diff, res, sample=1024, seed=9):
    """Step 1 of phase 9: every query through the card's packed step,
    pack_ds then the rank-only kernel (ops/rank.py
    rank_candidates_kernel), at block PACK_BLOCK in pow-2 n_blocks
    groups; all results == phase 4's, a seeded sample covering every
    group == the plain search_packed_ds, and the kernel timed on the
    batch's group with the most packed pairs."""
    import torch

    from document_search_engine_tpu_torch.ops.packed import (
        rank_candidates,
        search_packed_ds,
    )
    from document_search_engine_tpu_torch.ops.rank import (
        rank_candidates_kernel,
        rank_kernel,
    )

    host, seg = eng.segments[0]
    dev, base, n_docs = eng.device, host.doc_base, host.n_docs
    inputs = [pack_inputs(eng, b) for b in batches]
    groups = [pack_groups(eng, rows, found) for rows, _c, found in inputs]
    uploads = [(torch.from_numpy(rows).to(dev), torch.from_numpy(c).to(dev))
               for rows, c, _f in inputs]

    def step(rows_t, coeff_t, nb):
        d_key, ci = pack_chunk(eng, rows_t, coeff_t, nb)
        return rank_candidates_kernel(d_key, ci, base, block=PACK_BLOCK,
                                      s=rows_t.shape[1], k=K, n_docs=n_docs)

    # the counted run
    torch.cuda.synchronize()
    rank_kernel.launches = 0
    t0 = time.perf_counter()
    outs = []
    for (rows_t, coeff_t), grp in zip(uploads, groups):
        nq = rows_t.shape[0]
        vals = torch.empty((nq, K), dtype=torch.int32, device=dev)
        gids = torch.empty((nq, K), dtype=torch.int32, device=dev)
        for _idx, nb, chunks in grp:
            for ch in chunks:
                ch_t = torch.from_numpy(ch).to(dev)
                vals[ch_t], gids[ch_t] = step(rows_t[ch_t], coeff_t[ch_t], nb)
        outs.append((gids.cpu().numpy(), vals.cpu().numpy()))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res["launches"] = rank_kernel.launches
    res["step_qps"] = NQ * len(batches) / dt
    if res["launches"] <= 0:
        raise AssertionError("the packed step launched no rank_only kernel")
    assert_outs_equal(outs, base_outs, "packed step vs phase 4")
    totals = {}
    for grp in groups:
        for idx, nb, chunks in grp:
            t = totals.setdefault(nb, [0, 0])
            t[0] += len(idx)
            t[1] += len(chunks)
    res["groups"] = [{"n_blocks": nb, "c": nb * PACK_BLOCK, "queries": q,
                      "chunks": c} for nb, (q, c) in sorted(totals.items())]
    log(f"packed step (pack_ds + rank_only, block {PACK_BLOCK}): "
        f"{NQ * len(batches)} queries in {dt:.3f}s = {res['step_qps']:.1f} "
        f"q/s, {res['launches']} launches, groups {res['groups']}; all "
        "ids and scores == phase 4's")

    # a seeded sample of batch 0 covering every group vs the plain scorer
    rows_t, coeff_t = uploads[0]
    pick, n_live = sample_cells(np.random.default_rng(seed),
                                [(idx, None) for idx, _nb, _c in groups[0]],
                                NQ, min(sample, NQ))
    got_v, got_g = (torch.from_numpy(outs[0][1]).to(dev),
                    torch.from_numpy(outs[0][0]).to(dev))
    for idx, nb, _chunks in groups[0]:
        sel = np.intersect1d(idx, pick)
        step_q = max(1, PLAIN_CHUNK_ELEMS // (nb * PACK_BLOCK))
        for lo in range(0, len(sel), step_q):
            sel_t = torch.from_numpy(sel[lo : lo + step_q]).to(dev)
            v, g = search_packed_ds(
                seg.post_doc, seg.post_val, seg.indptr, seg.row_start,
                rows_t[sel_t], coeff_t[sel_t], SCALE, CLIP, base,
                n_blocks=nb, k=K, n_docs=n_docs, block=PACK_BLOCK)
            diff.check(got_v[sel_t], v, f"packed step vals, n_blocks {nb}")
            diff.check(got_g[sel_t], g, f"packed step gids, n_blocks {nb}")
    res["sampled_compared"] = len(pick)
    log(f"packed step: {len(pick)} sampled queries over {n_live} groups "
        "== the plain search_packed_ds")

    # the kernel on the group with the most packed pairs, vs plain
    idx, nb, chunks = max(groups[0], key=lambda g: len(g[0]) * g[1])
    s = rows_t.shape[1]
    chunk_t = [torch.from_numpy(ch).to(dev) for ch in chunks]

    def pack_all():
        return [pack_chunk(eng, rows_t[c], coeff_t[c], nb) for c in chunk_t]

    packed, pack_ms, _reps = timed(pack_all)
    got, ms, reps = timed(lambda: [
        rank_candidates_kernel(d, c, base, block=PACK_BLOCK, s=s, k=K,
                               n_docs=n_docs) for d, c in packed])
    want, plain_ms, plain_reps = timed(lambda: [
        rank_candidates(d, c, base, s, K, n_docs) for d, c in packed])
    for (gv, gg), (wv, wg) in zip(got, want):
        diff.check(gv, wv, "packed step timing vals")
        diff.check(gg, wg, "packed step timing gids")
    bound_ms, bound_by, cand = rank_bound([(d, c, None) for d, c in packed],
                                          K)
    res["largest_group"] = {
        "n_blocks": nb, "c": nb * PACK_BLOCK, "queries": len(idx),
        "kernel_ms": ms, "kernel_ms_reps": reps, "plain_ms": plain_ms,
        "plain_ms_reps": plain_reps, "pack_ms": pack_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "packed_pairs": cand,
    }
    log(f"packed step, batch 0's largest group ({len(idx)} queries at "
        f"n_blocks {nb}, C {nb * PACK_BLOCK}), median of {TIMED_REPS} warm "
        f"runs: rank_only {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms; pack_ds {pack_ms:.3f} ms; bit-identical")


def phase_dense(eng, batches, base_outs, res, seed=10):
    """Step 2 of phase 9: the dense reference (score_exact, then
    topk_ranked and topk_ranked_sort) on a seeded sample of phase 4's
    queries, in chunks of DENSE_CHUNK; each == phase 4's results."""
    import torch

    from document_search_engine_tpu_torch.engine.query import segment_rows
    from document_search_engine_tpu_torch.ops.exact import (
        row_cap,
        score_exact,
    )
    from document_search_engine_tpu_torch.ops.topk import (
        topk_ranked,
        topk_ranked_sort,
    )

    host, seg = eng.segments[0]
    dev = eng.device
    # the CSR in indptr-contiguous order, read out of the aligned planes
    ip = seg.indptr.long()
    lens = ip[1:] - ip[:-1]
    nnz = int(ip[-1])
    row_of = torch.repeat_interleave(
        torch.arange(lens.numel(), device=dev), lens)
    pos = (seg.row_start.long()[row_of]
           + torch.arange(nnz, device=dev) - ip[row_of])
    post_doc = seg.post_doc.reshape(-1)[pos]
    post_val = seg.post_val.reshape(-1)[pos].view(torch.float32)
    del row_of, pos
    n_pad = seg.n_docs_pad
    doc_ids = torch.arange(n_pad, dtype=torch.int32, device=dev) + (
        host.doc_base)
    pick = np.sort(np.random.default_rng(seed).choice(
        NQ * len(batches), size=DENSE_SAMPLE, replace=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, DENSE_SAMPLE, DENSE_CHUNK):
        sel = pick[lo : lo + DENSE_CHUNK]
        slot_h, coeff = eng.frontend.analyze(
            [batches[i // NQ][i % NQ] for i in sel], eng.stats)
        rows, found = segment_rows(host.term_hash, slot_h)
        coeff = np.where(found, coeff, np.float32(0.0))
        scores = score_exact(
            seg.indptr, post_doc, post_val, torch.from_numpy(rows).to(dev),
            torch.from_numpy(coeff).to(dev), SCALE, CLIP,
            cap=row_cap(host.indptr, rows[found]), n_docs_pad=n_pad)
        want_ids = np.stack([base_outs[i // NQ][0][i % NQ] for i in sel])
        want_sc = np.stack([base_outs[i // NQ][1][i % NQ] for i in sel])
        for fn in (topk_ranked, topk_ranked_sort):
            v, g = fn(scores, seg.alive, doc_ids, k=K)
            np.testing.assert_array_equal(
                g.cpu().numpy(), want_ids, f"dense {fn.__name__} ids")
            np.testing.assert_array_equal(
                v.cpu().numpy(), want_sc, f"dense {fn.__name__} scores")
    torch.cuda.synchronize()
    res["dense_sampled"] = DENSE_SAMPLE
    res["dense_s"] = time.perf_counter() - t0
    log(f"dense reference (score_exact + topk_ranked, topk_ranked_sort): "
        f"{DENSE_SAMPLE} sampled queries in chunks of {DENSE_CHUNK}, "
        f"{res['dense_s']:.2f}s; == phase 4's")


def phase_parity_scale(device, res, seed=8):
    """Step 3 of phase 9: SearchEngine on the card against the vectorized
    oracle at 20 Newsgroups' scale (PARITY_DOCS, BASELINE.json:8), bm25
    and tfidf, default scorer and xla_rank, k 10 and 100; again after
    one delete_docs + add_docs round. Ids and scores equal."""
    from document_search_engine_tpu_torch import (
        IndexConfig,
        ScoringConfig,
        SearchEngine,
    )
    from document_search_engine_tpu_torch.corpus.synth import (
        synth_corpus,
        synth_queries,
    )
    from document_search_engine_tpu_torch.oracle import VectorOracleEngine

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    docs = synth_corpus(n_docs=PARITY_DOCS, vocab_size=12_000, mean_len=60,
                        seed=seed)
    added = synth_corpus(n_docs=PARITY_DOCS // 20, vocab_size=12_000,
                         mean_len=60, seed=seed + 1)
    dead = rng.choice(PARITY_DOCS, size=PARITY_DOCS // 20, replace=False)
    queries = synth_queries(docs, n_queries=PARITY_QUERIES,
                            terms_per_query=5, seed=seed + 2)
    queries += ["", "zzznotaword", docs[0].split()[0]]
    n = 0
    for kind in ("bm25", "tfidf"):
        cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
        ora = VectorOracleEngine(cfg)
        ora.build(docs)
        engines = []
        for scorer in (None, "xla_rank"):
            e = SearchEngine(cfg, device=device)
            e.scorer = scorer
            e.build(docs)
            engines.append(e)
        for when in ("built", "after delete + add"):
            for k in (10, 100):
                want = ora.search(queries, k=k)
                for e in engines:
                    got = e.search(queries, k=k)
                    what = f"{kind} {e.scorer_mode} k={k} {when}"
                    np.testing.assert_array_equal(got[0], want[0], what)
                    np.testing.assert_array_equal(got[1], want[1], what)
                    n += 1
            if when == "built":
                for e in (ora, *engines):
                    e.delete_docs(dead.tolist())
                    e.add_docs(added)
    res["parity_docs"] = PARITY_DOCS
    res["parity_comparisons"] = n
    res["parity_s"] = time.perf_counter() - t0
    log(f"parity at scale: {PARITY_DOCS} docs, bm25 and tfidf, fused and "
        f"xla_rank, k 10 and 100, built and after a delete + add: {n} "
        f"comparisons == the vectorized oracle in {res['parity_s']:.1f}s")


def phase_entry(res):
    """Step 4 of phase 9: entry() on the card (its packed step launches
    the rank-only kernel) == the same step on CPU tensors, and
    dryrun_multichip(8) with every shard on the card."""
    import contextlib

    import torch

    from document_search_engine_tpu_torch.entry import (
        dryrun_multichip,
        entry,
    )
    from document_search_engine_tpu_torch.ops.rank import rank_kernel

    fn, args = entry()
    rank_kernel.launches = 0
    vals, gids = fn(*args)
    torch.cuda.synchronize()
    res["entry_launches"] = rank_kernel.launches
    if res["entry_launches"] <= 0:
        raise AssertionError("entry()'s step launched no rank_only kernel")
    fn_c, args_c = entry(device="cpu")
    want = fn_c(*args_c)
    for g, w, name in zip((vals, gids), want, ("vals", "gids")):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      f"entry {name}: card vs cpu")
    if not (vals[:, 0] > 0).all():
        raise AssertionError(f"entry: a query found nothing: {vals}")
    with contextlib.redirect_stdout(sys.stderr):
        dryrun_multichip(SHARD_COUNTS[-1])
    log(f"entry: {tuple(vals.shape)} == the CPU step, "
        f"{res['entry_launches']} rank_only launch(es); "
        f"dryrun_multichip({SHARD_COUNTS[-1]}) == the oracle")


def phase_prof(eng, batches, res):
    """Step 5 of phase 9: the engine's phase timers over one search, and
    one search_stream pass of the batches under prof.trace, after one
    pass untraced (every batch's graph captured: a steady window): the
    trace must hold the fused kernel's events; the card's busy share of
    the traced window (the union of its kernels over the span of all
    events) is reported."""
    import torch

    from document_search_engine_tpu_torch.utils import prof

    prof.reset()
    eng.search(batches[0], k=K)
    phases = json.loads(prof.metrics_json())["phases_s"]
    # on the card the dispatch's planning and enqueue (the step graph's
    # replay) and the collect's wait and assembly are phases of their own
    if set(phases) != {"search.analyze", "search.score", "dispatch.plan",
                       "dispatch.enqueue", "collect.wait",
                       "collect.assemble"}:
        raise AssertionError(f"search recorded phases {sorted(phases)}")
    res["search_phases_s"] = phases
    # a steady window: every batch's step graph captured before the trace
    serve_all(eng, batches)
    out_dir = os.path.join(REPO, "traces")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "chip_smoke_trace.json")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof.trace(path):
        serve_all(eng, batches)
    res["traced_s"] = time.perf_counter() - t0
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    fused = [e for e in kernels if "fused_search_kernel" in e["name"]]
    if not fused:
        raise AssertionError(f"the trace holds no fused_search kernel "
                             f"({len(kernels)} kernel events)")
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy = union_ms([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in kernels])
    # the host's torch operators (enqueue) on any thread, as a union
    host_ops = union_ms([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                         for e in events if e.get("cat") == "cpu_op"])
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    res["trace"] = {
        "bytes": os.path.getsize(path), "events": len(events),
        "kernel_events": len(kernels), "fused_events": len(fused),
        "window_ms": (end - start) / 1e3, "kernel_union_ms": busy,
        "busy_share": busy / ((end - start) / 1e3),
        "fused_ms": sum(e["dur"] for e in fused) / 1e3,
        "host_ops_union_ms": host_ops,
        "first_kernel_ms": (min(float(e["ts"]) for e in kernels)
                            - start) / 1e3,
        "top_kernels_ms": [[name[:80], ms] for name, ms in top],
    }
    t = res["trace"]
    log(f"trace of one search_stream pass ({res['traced_s']:.3f}s on the "
        f"host clock, {t['bytes']} B): {t['kernel_events']} kernels, "
        f"{t['fused_events']} fused_search, busy {t['kernel_union_ms']:.2f} "
        f"of {t['window_ms']:.2f} ms = {100 * t['busy_share']:.1f}% of the "
        f"window; torch operators on the host {t['host_ops_union_ms']:.2f} "
        f"ms; first kernel at {t['first_kernel_ms']:.2f} ms")


def phase_reference(device, texts, batches, base_outs, diffs):
    """Phase 9: the reference scorers and the entry points on the card.
    Phases 7 and 8 changed phase 4's engine, so its corpus is built
    again (the same build). Returns the results."""
    import torch

    from document_search_engine_tpu_torch import (
        IndexConfig,
        ScoringConfig,
        SearchEngine,
    )

    res = {"block": PACK_BLOCK}
    eng = SearchEngine(IndexConfig(scoring=ScoringConfig(kind="bm25")),
                       device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.build(texts)
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t0
    log(f"phase 9: phase 4's corpus built again in {res['build_s']:.1f}s")
    phase_packed(eng, batches, base_outs, diffs["rank_only"], res)
    phase_dense(eng, batches, base_outs, res)
    phase_parity_scale(device, res)
    phase_entry(res)
    phase_prof(eng, batches, res)
    return res


# ------------------------------------------------------------ phase 10
def phase_synth(device, res):
    """Step 1 of phase 10: the bench's own index (bench.build_synth_engine
    at its defaults; postings drawn on the card, so a row may hold a doc
    twice) held to the spec: batch 0 of its queries through the fused
    kernel equals the dense reference on DENSE_SAMPLE queries, and the
    xla_rank scorer (the rank-only kernel) on all NQ. Each kernel's
    launches are counted from 0 over its search."""
    import torch

    from document_search_engine_tpu_torch import (
        IndexConfig,
        ScoringConfig,
        bench,
    )
    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops.rank import rank_kernel

    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng, df, tokens = bench.build_synth_engine(
        SYNTH_DOCS, max(50_000, SYNTH_DOCS // 5), SYNTH_AVG_TERMS, cfg,
        seed=1, device=device)
    torch.cuda.synchronize()
    res["synth_build_s"] = time.perf_counter() - t0
    host, seg = eng.segments[0]
    flat = seg.post_doc.reshape(-1)
    row_head = torch.zeros(flat.numel(), dtype=torch.bool, device=device)
    row_head[seg.row_start.long()] = True
    res["synth_postings"] = int(host.indptr[-1])
    res["synth_slots"] = flat.numel()
    res["synth_resident_bytes"] = eng.resident_bytes()
    res["synth_repeated_docs"] = int(
        ((flat[1:] == flat[:-1]) & (flat[1:] < SYNTH_DOCS)
         & ~row_head[1:]).sum())
    del flat, row_head
    (batch,), avg = bench.make_batches(df, tokens, NQ, TERMS_PER_QUERY, 1)
    reset_launches()
    want = eng.search(batch, k=K)
    res["synth_fused_launches"] = F.fused_search.launches
    if res["synth_fused_launches"] <= 0:
        raise AssertionError("the synthetic index's search launched no "
                             "fused_search kernel")
    phase_dense(eng, [batch], [want], res, seed=12)
    eng.scorer = "xla_rank"
    reset_launches()
    got = eng.search(batch, k=K)
    res["synth_rank_launches"] = rank_kernel.launches
    if res["synth_rank_launches"] <= 0:
        raise AssertionError("xla_rank on the synthetic index launched no "
                             "rank_only kernel")
    assert_outs_equal([got], [want], "synthetic index: xla_rank vs fused")
    log(f"synthetic index: {SYNTH_DOCS} docs, {res['synth_postings']} "
        f"postings in {res['synth_slots']} slots, "
        f"{res['synth_repeated_docs']} repeated docs in rows, built in "
        f"{res['synth_build_s']:.1f}s; batch 0 (avg postings/query {avg}): "
        f"{DENSE_SAMPLE} == the dense reference, all {NQ} xla_rank == fused "
        f"({res['synth_fused_launches']} fused, "
        f"{res['synth_rank_launches']} rank_only launches)")


def phase_bench(device):
    """Phase 10: step 1 (phase_synth), then `python -m
    document_search_engine_tpu_torch bench` in a subprocess with every
    BENCH_* unset (bench.py's defaults, on the card), given the card
    with the parent's engines freed. It must exit 0 and print its JSON
    line with the sharded, 8M and stream legs present and a nonzero
    device pack time and step q/s, and its log must show a fused_search
    launch in each leg that serves. Returns the results: the line, the
    w/o-analysis q/s and each leg's seconds, peak bytes and kernel
    launches from the bench's log."""
    import gc
    import re

    import torch

    res = {}
    phase_synth(device, res)
    gc.collect()
    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "document_search_engine_tpu_torch", "bench"],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S,
    )
    res["bench_s"] = time.perf_counter() - t0
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"bench exited with {proc.returncode}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} JSON lines")
    out = json.loads(lines[0])
    missing = [key for key in ("sharded", "m8", "stream") if out[key] is None]
    missing += [key for key in ("device_pack_secs", "step_qps")
                if not out[key]]
    if missing:
        raise AssertionError(f"bench legs missing: {missing}")
    if out["m8"]["peak_bytes"] >= M8_PEAK_LIMIT_BYTES:
        raise AssertionError(
            f"bench 8M leg peaked at {out['m8']['peak_bytes']} B, not below "
            f"{M8_PEAK_LIMIT_BYTES} B")
    res["json"] = out
    wo = re.search(r"^serving w/o analysis: ([\d,]+) q/s", proc.stderr,
                   re.M)
    res["wo_analysis_qps"] = float(wo.group(1).replace(",", ""))
    res["legs"] = {
        m.group(1): {
            "s": float(m.group(2)),
            "peak_bytes": int(m.group(3)) if m.group(3).isdigit() else None,
            "launches": json.loads(m.group(4)),
        }
        for m in re.finditer(r"^leg (.+): ([\d.]+)s, peak device memory "
                             r"(\S+) B, kernel launches (\{.*\})$",
                             proc.stderr, re.M)
    }
    # the legs that serve through the fused kernel must have launched it
    idle = [leg for leg in ("warmup", "primary", "serving w/o analysis",
                            "device step only", "sharded serving", "8M")
            if res["legs"][leg]["launches"].get("fused_search", 0) <= 0]
    if idle:
        raise AssertionError(f"bench legs without a fused_search launch: "
                             f"{idle}")
    log(f"bench: {out['value']:,.0f} q/s best, {out['median']:,.0f} median; "
        f"w/o analysis {res['wo_analysis_qps']:,.0f}, step {out['step_qps']:,.0f}; "
        f"1-shard overhead {out['sharded']['overhead_median_pct']:+.1f}%; "
        f"pack {out['device_pack_secs']}s; 8M {out['m8']['median']:,.0f} q/s, "
        f"peak {out['m8']['peak_bytes']} B (gate < {M8_PEAK_LIMIT_BYTES}); "
        f"stream {out['stream']['docs_per_sec']:,.0f} docs/s; "
        f"{res['bench_s']:.1f}s in all")
    return res


def fuzz_coverage(configs) -> list:
    """What the fuzz's drawn trials miss of every scorer, shard count,
    split value and kind, k > 16 and each fused kernel route (B1: fused,
    no split, k <= 16; B2t: k > 16; dlim: a split)."""
    have = {(key, c[key]) for c in configs
            for key in ("scorer", "n_shards", "split", "kind")}
    need = ([("scorer", s) for s in ("fused", "xla", "xla_rank")]
            + [("n_shards", n) for n in (0, 1, 2, 4)]
            + [("split", s) for s in (None, 2, 4, 16)]
            + [("kind", s) for s in ("tfidf", "bm25")])
    missing = [f"{key}={v}" for key, v in need if (key, v) not in have]
    fused = [c for c in configs if c["scorer"] == "fused"]
    for what, hit in (
        ("k > 16", any(c["k"] > 16 for c in configs)),
        ("B1", any(c["split"] is None and c["k"] <= 16 for c in fused)),
        ("B2t", any(c["split"] is None and c["k"] > 16 for c in fused)),
        ("dlim", any(c["split"] is not None for c in fused)),
    ):
        if not hit:
            missing.append(what)
    return missing


def phase_tools(device):
    """Phase tools: the port's tools (document_search_engine_tpu_torch/
    tools/) on the card with fixed arguments, their printed lines sent to
    stderr. The differential fuzz: FUZZ_TRIALS trials from FUZZ_BASE,
    whose draws must cover fuzz_coverage's list, each bit-identical to
    the oracle after every step, with B1, dlim, B2t and the rank-only
    kernel launched. The segment curve at its defaults (96,000 docs as
    1, 2, 4, 8 and 16 segments, 8,192 queries a batch): every count must
    return the 1-segment results (the tool raises otherwise), launch
    kernels through at least one step graph, launch the segment merge
    once a batch of its timed pass over several segments and never over
    one (the kernels line's count), and the 1-segment results
    of a seeded SEG_ORACLE_SAMPLE of the queries must equal the
    vectorized oracle's (the dict oracle takes minutes on such queries;
    the two are held equal in tests/test_torch_vector_oracle.py). The
    host profile at its defaults (the bench's 1M index, 8,192 queries):
    its dummy step must have been captured into a graph, and every
    stage's time must be positive. Each tool's kernel counts start at 0.
    Then phase_tools_ab. Returns the readings of the "tools:" line."""
    import contextlib

    from document_search_engine_tpu_torch import IndexConfig, ScoringConfig
    from document_search_engine_tpu_torch.oracle import VectorOracleEngine
    from document_search_engine_tpu_torch.tools import (
        fuzz_differential,
        host_profile,
        segments_bench,
    )

    res = {}
    configs = [fuzz_differential.trial_config(
        FUZZ_BASE + i * fuzz_differential.SEED_STRIDE)
        for i in range(FUZZ_TRIALS)]
    missing = fuzz_coverage(configs)
    if missing:
        raise AssertionError(f"fuzz trials draw no {missing}")
    reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        fz = fuzz_differential.run_trials(FUZZ_BASE, FUZZ_TRIALS, device)
    idle = [name for name in ("fused_search", "fused_search_split",
                              "fused_search_large_k", "rank_only")
            if fz["launches"][name] <= 0]
    if idle:
        raise AssertionError(f"fuzz trials launched no {idle}")
    res["fuzz"] = {key: fz[key] for key in (
        "trials", "base_seed", "seconds", "captures", "launches")}
    log(f"tools: fuzz {FUZZ_TRIALS} trials passed in {fz['seconds']:.1f}s, "
        f"{fz['captures']} graph captures, launches {fz['launches']}")

    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        seg = segments_bench.main(device, env={})
    seg_s = time.perf_counter() - t0
    idle = [n for n, r in seg["per_count"].items()
            if r["launches_per_batch"] <= 0 or r["graphs"] < 1]
    if idle:
        raise AssertionError(f"segments: no kernel launch or graph at {idle}")
    merged = {n: r["batches"] if n > 1 else 0
              for n, r in seg["per_count"].items()}
    got = {n: r["merge_launches"] for n, r in seg["per_count"].items()}
    if got != merged or not sum(merged.values()):
        raise AssertionError(
            f"segments: segment merge launches {got}, batches merged {merged}")
    nq = len(seg["queries"])
    pick = np.sort(np.random.default_rng(14).choice(
        nq, size=min(SEG_ORACLE_SAMPLE, nq), replace=False))
    t0 = time.perf_counter()
    orc = VectorOracleEngine(IndexConfig(scoring=ScoringConfig(kind="bm25")))
    orc.build(seg["docs"])
    o_ids, o_sc = orc.search([seg["queries"][i] for i in pick],
                             k=segments_bench.K)
    assert_outs_equal([(seg["ids"][pick], seg["scores"][pick])],
                      [(o_ids, o_sc)], "segments 1-segment vs the oracle")
    oracle_s = time.perf_counter() - t0
    res["segments"] = {
        "curve": seg["curve"],
        "relative": {n: q / seg["curve"][1] for n, q in seg["curve"].items()},
        "per_count": seg["per_count"], "seconds": seg_s,
        "oracle_sample": len(pick), "oracle_s": oracle_s,
        "merge_launches": sum(got.values()),
    }
    log(f"tools: segments curve {seg['curve']} in {seg_s:.1f}s; "
        f"{sum(got.values())} segment merge launches in as many merged "
        f"batches; 1-segment results equal the oracle on {len(pick)} "
        f"queries ({oracle_s:.1f}s)")
    del seg, orc

    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        hp = host_profile.main(device, env={})
    hp_s = time.perf_counter() - t0
    if hp["captures"] < 1:
        raise AssertionError("host_profile: the dummy step was not captured")
    bad = [key for key in ("analyze_ms", "dispatch_ms", "collect_ms",
                           "plan_ms", "enqueue_ms") if not hp[key] > 0]
    if bad:
        raise AssertionError(f"host_profile: no time for {bad}")
    res["host_profile"] = {key: hp[key] for key in (
        "analyze_ms", "dispatch_ms", "plan_ms", "enqueue_ms", "collect_ms",
        "total_ms", "ceiling_qps", "captures")}
    res["host_profile"]["seconds"] = hp_s
    res["host_profile"]["profile_top10"] = [
        f"{fn}: {cum:.4f}" for fn, cum in hp["profile_top"][:10]]
    log(f"tools: host profile analyze {hp['analyze_ms']:.2f} / dispatch "
        f"{hp['dispatch_ms']:.2f} (plan {hp['plan_ms']:.2f}, enqueue "
        f"{hp['enqueue_ms']:.2f}) / collect {hp['collect_ms']:.2f} ms in "
        f"{hp_s:.1f}s")
    res.update(phase_tools_ab(device))
    return res


def phase_tools_ab(device):
    """The rest of phase tools: the lever A/B, the batch-size A/B and the
    roofline at their defaults, on one bench index they share
    (bench.build_synth_engine: 1M docs, 200,000 terms, 60 postings a
    doc, seed 1). step_ab: every setting bit-identical to the baseline
    (the tool raises otherwise) and at least one graph captured after
    each apply. nq_ab: every leg's passes return nq x iters rows with no
    graph captured inside a timed pass. roofline: the captured buckets'
    real postings equal the natural plan's, and no bucket measures below
    its bound (the tool raises on either; checked here again). Each
    tool's kernel counts start at 0. Returns their readings."""
    import contextlib

    from document_search_engine_tpu_torch import (
        IndexConfig,
        ScoringConfig,
        bench,
    )
    from document_search_engine_tpu_torch.tools import nq_ab, roofline, step_ab

    res = {}
    t0 = time.perf_counter()
    built = bench.build_synth_engine(
        SYNTH_DOCS, max(50_000, SYNTH_DOCS // 5), SYNTH_AVG_TERMS,
        IndexConfig(scoring=ScoringConfig(kind="bm25")), seed=1,
        device=device)
    res["ab_index_s"] = time.perf_counter() - t0

    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        ab = step_ab.main(device, env={}, built=built)
    idle = [r["name"] for r in ab["results"] if r["captures"] < 1]
    if idle:
        raise AssertionError(f"step_ab: no graph captured after {idle}")
    res["step_ab"] = {"nq": ab["nq"], "iters": ab["iters"],
                      "results": ab["results"],
                      "launches": bench.launch_counts(),
                      "seconds": time.perf_counter() - t0}
    log(f"tools: step_ab "
        f"{[(r['name'], round(r['ms'], 3)) for r in ab['results']]}, every "
        f"setting bit-identical, in {res['step_ab']['seconds']:.1f}s")

    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        nqr = nq_ab.main(device, env={}, built=built)
    for nq, leg in nqr["legs"].items():
        bad = [p for p in leg["passes"] if p["captures"] != 0
               or p["n_out"] != nq * leg["iters"]]
        if bad:
            raise AssertionError(f"nq_ab nq={nq}: passes {bad}")
    res["nq_ab"] = {"legs": nqr["legs"], "launches": bench.launch_counts(),
                    "seconds": time.perf_counter() - t0}
    log("tools: nq_ab " + ", ".join(
        f"nq={nq} median {leg['median']:,.0f} q/s, step {leg['step_qps']:,.0f}"
        for nq, leg in nqr["legs"].items())
        + f" in {res['nq_ab']['seconds']:.1f}s")

    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rf = roofline.main(device, env={}, built=built)
    del built
    post = rf["real_postings"]
    if post["captured"] != post["natural"]:
        raise AssertionError(f"roofline: real postings {post}")
    low = [a["bucket"] for a in rf["card"] if not a["ms"] >= a["bound_ms"]]
    if low:
        raise AssertionError(f"roofline: buckets below their bound: {low}")
    res["roofline"] = {
        "peaks": rf["peaks"], "real_postings": post,
        "natural_buckets": rf["natural_buckets"],
        "host": [_roof_row(a) for a in rf["host"]],
        "card": [_roof_row(a) for a in rf["card"]],
        "seconds": time.perf_counter() - t0,
    }
    log(f"tools: roofline {len(rf['card'])} buckets, "
        f"{sum(a['ms'] for a in rf['card']):.4f} ms against "
        f"{sum(a['bound_ms'] for a in rf['card']):.4f} ms of bounds, "
        f"dominant {[a.get('dominant') or a['kernel'] for a in rf['card']]}"
        f", in "
        f"{res['roofline']['seconds']:.1f}s")
    return res


def _roof_row(a):
    """One roofline bucket for the tools line: its shape, kernel, launch,
    counts, stage bounds (ms, by; B1's buckets only), bound and time."""
    row = {key: a.get(key) for key in (
        "bucket", "threads", "blocks_per_sm", "placement", "real_pairs",
        "runs_max", "levels_max", "barriers", "stage_sum_ms", "bound_ms",
        "bound_by", "dominant", "ms")}
    row["kernel"] = a.get("kernel", "fused_search")
    if "stages" in a:
        row["stages"] = {st: [v["ms"], v["by"]]
                         for st, v in a["stages"].items()}
    return row


def thread_sweep(threads=(256, 1024)):
    """The measurement behind ops/fused.py THREADS_BY_RC, on the card:
    each bucket of one main-path batch (fused at k = 10 and 64, the dv
    plane, split_rows 128) at every thread count in `threads` (each must
    be one the library was built for), against the plain version, timed
    as the median of TIMED_REPS warm runs, with resident blocks an SM.
    Prints one JSON line a bucket and thread count:

        python3 -c "import chip_smoke; chip_smoke.thread_sweep()"
    """
    import torch

    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops.fused_dv import fused_search_dv

    if not torch.cuda.is_available():
        raise SystemExit("thread_sweep: CUDA is not available")
    print(f"card: {card_line()}", flush=True)
    eng, batches, _texts = main_engine(torch.device("cuda"), {})
    rule = F.launch_threads
    diff = Diff()
    try:
        for scorer, split, k in (("fused", None, K), ("fused_dv", None, K),
                                 ("fused", 128, K),
                                 ("fused", None, CANDIDATES)):
            eng.scorer, eng.split_rows = scorer, split
            eng.preplan(batches, k=k)
            for seg, t, p, dl, dv in bucket_calls(
                    capture_batch(eng, batches[0], k)):
                want = plain_chunks(seg, t, p, dl, dv)

                def run():
                    if dv is not None:
                        return fused_search_dv(dv, *t, **p)
                    return F.fused_search(seg.post_doc, seg.post_val, *t,
                                          dlim=dl, **p)

                load = 2 if dv is not None else int(dl is not None)
                for n in threads:
                    F.launch_threads = lambda r_c, n=n: n
                    got, ms, reps = timed(run)
                    diff.check(got[0], want[0], "thread sweep vals")
                    diff.check(got[1], want[1], "thread sweep docs")
                    print(json.dumps({
                        "scorer": scorer, "split_rows": split, "k": k,
                        "bucket": [int(t[0].shape[0]), p["n_blocks"],
                                   p["block"], p["r_c"]],
                        "threads": n, "ms": ms, "ms_reps": reps,
                        "blocks_per_sm": F._lib().dse_fused_blocks_per_sm(
                            load, n, p["r_c"], p["n_blocks"]),
                    }), flush=True)
    finally:
        F.launch_threads = rule
        eng.scorer, eng.split_rows = None, None


def kernel_entry(name, launches, diff, ms, plain_ms, bound_ms, bound_by,
                 library_ms):
    source, replaces = KERNELS[name]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": diff.max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def batch_entry(name, launches, diffs, batch):
    """A kernels-line entry timed on one batch's buckets of that kernel
    (time_batch_buckets' by_kernel; None where the batch has none)."""
    b = batch["by_kernel"].get(name, {})
    return kernel_entry(name, launches, diffs[name], b.get("ms"),
                        b.get("plain_ms"), b.get("bound_ms"),
                        b.get("bound_by"), None)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from document_search_engine_tpu_torch.ops import fused as F

    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    so = F.build_kernels()
    build_s = time.perf_counter() - t0
    if F._lib().dse_smem_max_bytes() != F.SMEM_MAX_BYTES:
        raise AssertionError("ops/fused.py SMEM_MAX_BYTES != the library's")
    log(f"kernel library built in {build_s:.1f}s: {so.name}\n"
        + so.with_suffix(".log").read_text())

    diffs = {name: Diff() for name in KERNELS}
    l_fused, l_dlim = phase_load_fused(device, diffs)
    m_fused, m_dlim = phase_merge_fused(device, diffs)
    n = phase_kernels(device, diffs) + m_fused + l_fused
    log(f"phase 2: {n} fused and dv kernel-vs-plain cases bit-identical")
    n = phase_split(device, diffs["fused_search_split"]) + m_dlim + l_dlim
    log(f"phase 2: {n} dlim kernel-vs-plain cases bit-identical")
    n = phase_rank(device, diffs["rank_only"])
    n += phase_merge_rank(device, diffs["rank_only"])
    log(f"phase 2: {n} rank kernel-vs-plain cases bit-identical")
    n = phase_dots(device, diffs["rerank_dots"])
    log(f"phase 2: {n} dots kernel-vs-plain cases bit-identical")
    n, merge_ms = phase_segment_merge(device, diffs["segment_merge"])
    log(f"phase 2: {n} segment merge kernel-vs-plain cases bit-identical")
    n = phase_oracle(device)
    log(f"phase 3: {n} oracle and rerank comparisons bit-identical")
    res, eng, batches, outs, texts = phase_main(device, diffs)
    res["kernel_build_s"] = build_s
    print("main path: " + json.dumps(res), flush=True)
    rr, rerank_outs = phase_rerank(eng, batches, diffs)
    print("rerank path: " + json.dumps(rr), flush=True)
    pp = phase_paths(eng, batches, outs, diffs)
    print("further paths: " + json.dumps(pp), flush=True)
    gr = phase_graphs(eng, batches)
    gr["phase4_pool"] = {key: res[key] for key in (
        "graphs", "graph_pool_bytes", "eager_step_pool_bytes",
        "eager_step_peak_bytes")}
    lc = phase_lifecycle(eng, batches, outs, texts)
    print("lifecycle path: " + json.dumps(lc), flush=True)
    sh = phase_sharded(eng, batches, outs, rerank_outs, texts,
                       gr["cycles_per_ms"])
    print("sharded path: " + json.dumps(sh), flush=True)
    gr["sharded"] = {
        n: {"bits": r["graph_bits"], "no_wait": r["graph_no_wait"],
            "dispatch": r["graph_dispatch"], "dispatch_ms": r["dispatch_ms"]}
        for n, r in sh["per_shards"].items()}
    ref = phase_reference(device, texts, batches, outs, diffs)
    del texts
    print("reference path: " + json.dumps(ref), flush=True)
    # the bench subprocess gets the card without phase 4's engine
    del eng, batches, outs, rerank_outs
    bn = phase_bench(device)
    print("bench: " + json.dumps(bn), flush=True)
    gr["busy_share"] = ref["trace"]["busy_share"]
    gr["bench"] = {key: bn["json"][key]
                   for key in ("value", "median", "step_qps")}
    print("graphs: " + json.dumps(gr), flush=True)
    tl = phase_tools(device)
    print("tools: " + json.dumps(tl), flush=True)
    b10, b64 = res["batch_k10"], rr["batch_k64"]
    kernels = [
        # each from its own buckets of the batch (time_batch_buckets'
        # by_kernel): phase 4's k 10 batch serves B1 and the tiled kernels
        batch_entry("fused_search", res["launches"], diffs, b10),
        batch_entry("fused_search_large_k", rr["launches_large_k"], diffs,
                    b64),
        kernel_entry("rerank_dots", rr["dots_launches"], diffs["rerank_dots"],
                     rr["dots_ms"], rr["dots_plain_ms"], rr["dots_bound_ms"],
                     rr["dots_bound_by"], rr["dots_library_ms"]),
        batch_entry("fused_tiled", res["launches_tiled"], diffs, b10),
    ]
    for _scorer, _split, name in PATHS:
        # the rank-only kernel's count: the xla_rank path's launches and
        # phase 9's packed step's
        launches = pp[name]["launches"] + (
            ref["launches"] if name == "rank_only" else 0)
        kernels.append(batch_entry(name, launches, diffs,
                                   pp[name]["batch"]))
    # the merge's launches: the segment curve's timed passes over several
    # segments (phase tools), its time at the live index's batch
    live = merge_ms["k100"]
    kernels.append(kernel_entry(
        "segment_merge", tl["segments"]["merge_launches"],
        diffs["segment_merge"], live["ms"], live["plain_ms"],
        live["bound_ms"], live["bound_by"], None))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
