#!/usr/bin/env python3
"""Smoke test of the torch port on one NVIDIA GPU: build -> search_stream,
the hybrid rerank path search_rerank, the xla_rank, fused_dv and
doc-range split serving paths, and the index lifecycle (streaming build,
delete, compact, save/load, the CLI).

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
   with no live candidate and the table's last row. Results must be
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
   raw-text queries (8 terms of df 64..32768 each), k=10, depth 2. The
   kernel's launch count over that run must be > 0, and per batch a
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
   resident after); save, then SearchEngine.load on the card by default:
   the same resident bytes and results, and no layout grows on replay;
   the CLI (index, 16 searches, serve) with its default device on a
   2,000-doc corpus, whose printed hits must equal the library's. The
   fused kernel and its dv and dlim load stages must have launched.
   Reported: the seconds of the streaming build (and the share of its
   final compact), the delete, the compact, save and load; the peak
   device bytes of the build and the compact; the checkpoint's bytes;
   serving q/s after the compact (the median of 5 passes).

stdout ends with the lifecycle path's JSON line, the kernels' JSON line, the card's name and power
limit, and {"ok": true, "device": {...}} as the last line. Progress goes
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
PLANES = ("post_doc", "post_val", "post_tf", "indptr", "row_start")


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
    version; returns hits. With `cut` the kernels read planes cut after
    that many rows (the plain versions, which read whole blocks, keep
    them)."""
    import torch

    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops import fused_dv as FD

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
    torch.cuda.synchronize()
    diff = diffs[fused_name(k)]
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
def synth_text_batches(n_docs, vocab, mean_len, batch_docs, seed=3):
    """Zipf text: tokens s000000.. drawn with p ~ 1/rank, Poisson(mean)
    lengths (>= 5) — the corpus of bench.py's streaming leg."""
    rng = np.random.default_rng(seed)
    tokens = np.array([f"s{i:06d}" for i in range(vocab)])
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    cdf = np.cumsum(1.0 / ranks)
    cdf /= cdf[-1]
    out = []
    for lo in range(0, n_docs, batch_docs):
        nb = min(batch_docs, n_docs - lo)
        lens = np.maximum(5, rng.poisson(mean_len, nb))
        ptr = np.zeros(nb + 1, np.int64)
        np.cumsum(lens, out=ptr[1:])
        toks = tokens[np.searchsorted(cdf, rng.random(int(ptr[-1])))]
        out.extend(" ".join(toks[ptr[i] : ptr[i + 1]]) for i in range(nb))
    return tokens, out


def make_batches(df_by_row, tokens_by_row, nq, tpq, n_batches, seed=7):
    """Raw-text query batches: tpq terms per query drawn uniformly from
    the rows with 64 <= df <= 32768 (bench.py make_batches)."""
    rng = np.random.default_rng(seed)
    eligible = np.where((df_by_row >= 64) & (df_by_row <= 32768))[0]
    batches = []
    for _ in range(n_batches):
        rows = rng.choice(eligible, size=(nq, tpq))
        batches.append([" ".join(tokens_by_row[r] for r in qr) for qr in rows])
    return batches


def bucket_calls(captured):
    """Per bucket of one captured _batch_step: (segment, plan tables,
    the kernel's keyword arguments, dlim or None, dv plane or None)."""
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
    arguments."""
    from document_search_engine_tpu_torch.engine import engine as engine_mod

    captured = {}
    step = engine_mod._batch_step

    def capture_step(*a, **kw):
        captured["args"], captured["kw"] = a, kw
        return step(*a, **kw)

    engine_mod._batch_step = capture_step
    try:
        slot_h, coeff, rows_g, found_g = eng.frontend.analyze_rows(
            batch, eng.stats)
        eng._collect(eng._dispatch(slot_h, coeff, k, rows_g, found_g))
    finally:
        engine_mod._batch_step = step
    return captured


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


def launch_report(mode, call, k):
    """A bucket's launch: threads a block and resident blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor; not reported for the
    rank-only kernel)."""
    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops.rank import THREADS

    if mode == "xla_rank":
        return {"threads": THREADS, "blocks_per_sm": None}
    _seg, _tabs, p, dlim, dv = call
    threads = F.launch_threads(p["r_c"])
    load = 2 if dv is not None else int(dlim is not None)
    return {"threads": threads,
            "blocks_per_sm": F._lib().dse_fused_blocks_per_sm(
                load, threads, p["r_c"], p["n_blocks"])}


def time_batch_buckets(eng, batch, k, diff, res, key):
    """One batch's buckets at k, captured from a dispatch in the
    engine's current mode: the path's kernel (the fused kernel, its dlim
    or dv load stage, or the rank-only kernel) against its plain version
    in full, each timed as the median of TIMED_REPS warm runs; the bound
    from the same inputs."""
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

        def run_plain():
            return [rank_chunks(d, ci, p) for d, ci, p in packed]

        def stats(i):
            d, ci, p = packed[i]
            c = d.shape[1]
            return (*run_statistics(d, ci, p["block"], p["n_docs"]), c,
                    smem_words(c // p["block"], c))

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

        def run_plain():
            return [plain_chunks(s, t, p, dl, dv)
                    for s, t, p, dl, dv in calls]

        out["bound_ms"], out["bound_by"], out["real_postings"] = (
            fused_bound(calls))
    def run_kernel():
        return [run_bucket(i) for i in range(len(calls))]

    got, out["kernel_ms"], out["kernel_ms_reps"] = timed(run_kernel)
    want, out["plain_ms"], out["plain_ms_reps"] = timed(run_plain)
    for i, ((gv, gd), (wv, wd)) in enumerate(zip(got, want)):
        diff.check(gv, wv, f"{key} bucket {i} vals")
        diff.check(gd, wd, f"{key} bucket {i} docs")
    del got, want
    # where the kernel's time sits: each bucket alone, with its queries'
    # natural runs and real pairs
    out["per_bucket"] = []
    for i, shape in enumerate(out["buckets"]):
        _o, ms, reps = timed(lambda: run_bucket(i))
        out["per_bucket"].append(bucket_report(shape, ms, reps, *stats(i)))
        b = out["per_bucket"][-1]
        b.update(launch_report(eng.scorer_mode, calls[i], k))
        log(f"{key} bucket [nq, n_blocks, block, r_c] {shape}: {ms:.3f} ms, "
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
        f"workspace {out['max_workspace_bytes']} B")
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


def main_engine(device, res):
    """The main path's index (phase 4): the 1M-doc corpus built through
    SearchEngine.build (its build time, postings and resident bytes into
    res), and its N_BATCHES query batches. Returns (engine, batches,
    texts)."""
    import torch

    from document_search_engine_tpu_torch import (
        IndexConfig,
        ScoringConfig,
        SearchEngine,
    )
    from document_search_engine_tpu_torch.analyze.hashing import TermHasher

    n_docs, nq, n_batches = N_DOCS, NQ, N_BATCHES
    t0 = time.perf_counter()
    tokens, texts = synth_text_batches(n_docs, VOCAB, MEAN_LEN, 125_000)
    log(f"corpus: {n_docs} docs generated in "
        f"{time.perf_counter() - t0:.1f}s (not part of the build time)")
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    eng = SearchEngine(cfg, device=device)
    sync = torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    eng.build(texts)
    sync()
    res["build_s"] = time.perf_counter() - t0
    host = eng.segments[0][0]
    res["postings"] = int(host.indptr[-1])
    res["resident_bytes"] = eng.resident_bytes()
    log(f"build: {n_docs} docs, {res['postings']} postings, "
        f"{res['resident_bytes']} resident bytes in {res['build_s']:.1f}s")

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
    batches = make_batches(df_by_row, tokens_by_row, nq, TERMS_PER_QUERY,
                           n_batches)
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
    t0 = time.perf_counter()
    outs = list(eng.search_stream(batches, k=k, depth=depth))
    sync()
    dt = time.perf_counter() - t0
    res["launches"] = F.fused_search.launches
    res["launches_large_k"] = F.fused_search.launches_large_k
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
    if res["launches"] <= 0:
        raise AssertionError("the main path launched no fused_search kernel")
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
    time_batch_buckets(eng, batches[0], k, diffs["fused_search"], res,
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
    """Phase 5: search_rerank at full size on phase 4's index."""
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
    time_batch_buckets(eng, batches[0], kk, diffs["fused_search_large_k"],
                       res, "batch_k64")

    # where a batch's time goes: search_rerank's stages, one batch at a
    # time on the host clock (device stages end in their D2H read)
    dev = eng.device
    stages = {n: [] for n in ("analyze", "lexical", "query_emb",
                              "dots_and_d2h", "order")}
    for b in batches:
        t0 = time.perf_counter()
        slot_h, coeff, rows_g, found_g = eng.frontend.analyze_rows(
            b, eng.stats)
        t1 = time.perf_counter()
        gids, lex = eng._collect(
            eng._dispatch(slot_h, coeff, kk, rows_g, found_g))
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
    return res


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

    for attr in ("launches", "launches_large_k", "launches_dlim",
                 "launches_dv"):
        setattr(F.fused_search, attr, 0)
    rank_kernel.launches = 0


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
        time_batch_buckets(eng, batches[0], k, diffs[name], r, "batch")
        if scorer == "fused":
            # buckets that are still given a workspace
            r["workspace_buckets"] = sum(
                1 for b in r["batch"]["per_bucket"]
                if b["region"] == "per query")
        res[name] = r
    eng.scorer, eng.split_rows = None, None
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


def phase_cli(device, seed=13):
    """Step 6 of phase 7: the CLI with its default device (the card, which
    must be `device`) on a small corpus written as files: index, then
    search for each query and serve them all from a stdin stream; the
    printed hits must equal SearchEngine.load(index).search on the same
    queries."""
    import contextlib
    import io
    import re
    import tempfile

    from document_search_engine_tpu_torch import SearchEngine, cli
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
        info = json.loads(run(["index", corpus, "--out", idx]))
        if info["docs"] != CLI_DOCS:
            raise AssertionError(f"cli index: {info}")
        with open(os.path.join(idx, "docnames.json")) as f:
            names = json.load(f)
        lib = SearchEngine.load(idx)
        if lib.device != device:
            raise AssertionError(f"SearchEngine.load opened on {lib.device}")
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
    log(f"streaming build: {res['n_docs']} docs in 8 batches, "
        f"{res['streaming_build_s']:.2f}s ({compact_s[0]:.2f}s of it the "
        f"final compact), peak {res['streaming_peak_extra_bytes']} B above "
        f"the start; planes and all {nq} results == phase 4's")

    # 2. one delete of 10%, on both engines
    rng = np.random.default_rng(seed)
    dead = rng.choice(len(texts), size=N_DELETE, replace=False)
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
        f"{res['compact_peak_extra_bytes']} B above the start; allocated "
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
    n = phase_oracle(device)
    log(f"phase 3: {n} oracle and rerank comparisons bit-identical")
    res, eng, batches, outs, texts = phase_main(device, diffs)
    res["kernel_build_s"] = build_s
    print("main path: " + json.dumps(res), flush=True)
    rr = phase_rerank(eng, batches, diffs)
    print("rerank path: " + json.dumps(rr), flush=True)
    pp = phase_paths(eng, batches, outs, diffs)
    print("further paths: " + json.dumps(pp), flush=True)
    lc = phase_lifecycle(eng, batches, outs, texts)
    del texts
    print("lifecycle path: " + json.dumps(lc), flush=True)
    b10, b64 = res["batch_k10"], rr["batch_k64"]
    kernels = [
        kernel_entry("fused_search", res["launches"], diffs["fused_search"],
                     b10["kernel_ms"], b10["plain_ms"], b10["bound_ms"],
                     b10["bound_by"], None),
        kernel_entry("fused_search_large_k", rr["launches_large_k"],
                     diffs["fused_search_large_k"], b64["kernel_ms"],
                     b64["plain_ms"], b64["bound_ms"], b64["bound_by"], None),
        kernel_entry("rerank_dots", rr["dots_launches"], diffs["rerank_dots"],
                     rr["dots_ms"], rr["dots_plain_ms"], rr["dots_bound_ms"],
                     rr["dots_bound_by"], rr["dots_library_ms"]),
    ]
    for _scorer, _split, name in PATHS:
        b = pp[name]["batch"]
        kernels.append(kernel_entry(
            name, pp[name]["launches"], diffs[name], b["kernel_ms"],
            b["plain_ms"], b["bound_ms"], b["bound_by"], None))
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
