#!/usr/bin/env python3
"""Smoke test of the torch port on one NVIDIA GPU: build -> search_stream.

    python3 chip_smoke.py            # the full run, one card, < 20 min

Phases, each of which fails the run (non-zero exit, no result line):

1. Card and build: requires CUDA, prints the card's name and power limit
   (nvidia-smi), builds the fused search kernel from csrc/ with nvcc.
2. Kernel against its plain version, on the card: seeded random plans
   covering shared-memory and global-workspace regions, k in {1, 10, 16},
   unique keys (kb > 0) and plain doc keys (kb = 0), missing slots, rem
   tails, skipped blocks, duplicate rows (ties), an empty segment and
   several buckets. Results must be bit-identical.
3. Oracle parity on the card: SearchEngine(device="cuda") equals the
   frozen CPU oracle in ids and integer scores (bm25 and tfidf).
4. The main path at full size: a 1,000,000-doc bm25 index (200k-term
   Zipf vocabulary, 40 tokens per doc on average) built through
   SearchEngine.build, then search_stream over 4 batches of 16,384
   raw-text queries (8 terms of df 64..32768 each), k=10, depth 2. The
   kernel's launch count over that run must be > 0, and per batch a
   seeded sample of >= 1,024 queries covering every bucket cell must
   equal the plain scorer on the card. Serving q/s is the median of 5
   more passes. One batch's buckets are then compared in full, kernel
   against plain version, and each is timed as the median of 5 warm
   runs.

stdout ends with the kernels' JSON line, the card's name and power
limit, and {"ok": true, "device": {...}} as the last line. Progress goes
to stderr.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "document_search_engine_tpu_torch/csrc/fused_search.cu"
KERNEL_REPLACES = "document_search_engine_tpu/ops/fused_pallas.py:288"
SCALE = float(np.float32(2.0**16))
CLIP = float(np.float32(65075262.0))
# the main path's size: the corpus and traffic of bench.py's streaming
# leg, never cut
N_DOCS, VOCAB, MEAN_LEN = 1_000_000, 200_000, 40
NQ, N_BATCHES, TERMS_PER_QUERY, K, DEPTH = 16384, 4, 8, 10, 2
SERVING_PASSES = 5  # timed search_stream passes after the counted one
TIMED_REPS = 5  # event-timed repetitions per version, after one warm run


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
def aligned_csr(rng, n_terms, doc_space, max_len, n_docs):
    """Random CSR rows of unique ascending docs drawn from
    [0, doc_space), in the builder's aligned (X, 128) plane layout with
    sentinel doc n_docs in the padding. Returns (indptr, row_start, d2,
    v2)."""
    from document_search_engine_tpu_torch.index.builder import (
        aligned_geometry,
    )

    lens = rng.integers(0, max_len + 1, n_terms)
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


def phase_kernels(device, diff: Diff, seed: int = 0) -> int:
    """Kernel vs plain version on random plans; returns cases checked."""
    import torch

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
        sr, rm, ab, dst = F.expand_plan_tables(
            t(row_start), t(indptr), t(rows), t(coeff.view(np.int32)),
            nb, block,
        )
        need_r = int(F._compact_rows(rm[:, 0, :], block).sum(1).max())
        r_c = 1 << int(np.ceil(np.log2(max(need_r, 1))))
        kb = F.key_bits_for(s, n_docs) if kbm == "auto" else 0
        for rc in (r_c, 2 * r_c):  # tight and dominated regions
            got = F.fused_search(
                t(d2), t(v2), sr, rm, ab, dst, n_blocks=nb, block=block,
                s=s, k=k, n_docs=n_docs, scale=SCALE, clip=CLIP, r_c=rc,
                key_bits=kb,
            )
            want = plain_on(device, d2, v2, sr, rm, ab, nb, block, s, k,
                            n_docs)
            torch.cuda.synchronize()
            what = (f"case {ci} (nq={nq} nb={nb} block={block} r_c={rc} "
                    f"k={k} kb={kb})")
            diff.check(got[0], want[0], what + " vals")
            diff.check(got[1], want[1], what + " docs")
            hits = int((got[0] > 0).sum())
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
    got = F.fused_search(
        d_e, d_e, sr, rm, ab, dst, n_blocks=4, block=1024, s=4, k=10,
        n_docs=0, scale=SCALE, clip=CLIP, r_c=8, key_bits=2,
    )
    diff.check(got[0], torch.full_like(got[0], -1), "empty segment vals")
    diff.check(got[1], torch.full_like(got[1], -1), "empty segment docs")
    return n_checked + 1


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
    """Port engine on the card vs the frozen CPU oracle."""
    from document_search_engine_tpu_torch import (
        IndexConfig,
        ScoringConfig,
        SearchEngine,
    )
    from document_search_engine_tpu_torch.shared import (
        OracleEngine,
        synth_corpus,
        synth_queries,
    )

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
            for k in (1, 10, 16):
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
                f"k in (1, 10, 16) and search_stream")
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
    """Per bucket of one captured _batch_step: the kernel's arguments."""
    from document_search_engine_tpu_torch.ops.fused import (
        expand_plan_tables,
        key_bits_for,
    )

    segments, rows_cat, cbits_cat = captured["args"]
    kw = captured["kw"]
    calls, off = [], 0
    for (n_docs, _base, seg), (_nd, s, buckets) in zip(segments, kw["plan"]):
        for n_blocks, block, bq, r_c in buckets:
            tabs = expand_plan_tables(
                seg.row_start, seg.indptr, rows_cat[off : off + bq],
                cbits_cat[off : off + bq], n_blocks, block,
            )
            off += bq
            calls.append((seg, tabs, dict(
                n_blocks=n_blocks, block=block, s=s, k=kw["k"],
                n_docs=n_docs, scale=kw["scale"], clip=kw["clip"], r_c=r_c,
                key_bits=key_bits_for(s, n_docs),
            )))
    return calls


def plain_chunks(seg, tabs, p, chunk_elems=64 << 20):
    """The plain version over a bucket, in query chunks whose
    (rows, n_blocks * block) buffers stay ~64M elements."""
    import torch

    from document_search_engine_tpu_torch.ops.packed import (
        search_packed_tables,
    )

    nq = tabs[0].shape[0]
    step = max(1, chunk_elems // (p["n_blocks"] * p["block"]))
    vs, ds = [], []
    for lo in range(0, nq, step):
        sr, rm, ab = (x[lo : lo + step] for x in tabs[:3])
        v, d = search_packed_tables(
            seg.post_doc, seg.post_val, sr, rm, ab, p["scale"], p["clip"],
            0, n_blocks=p["n_blocks"], block=p["block"], s=p["s"],
            k=p["k"], n_docs=p["n_docs"],
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


def phase_main(device, diff: Diff, sample=1024, seed=0):
    import torch

    from document_search_engine_tpu_torch import (
        IndexConfig,
        ScoringConfig,
        SearchEngine,
    )
    from document_search_engine_tpu_torch.engine import engine as engine_mod
    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.shared import TermHasher, native

    n_docs, nq, n_batches, k, depth = N_DOCS, NQ, N_BATCHES, K, DEPTH
    res = {"n_docs": n_docs, "vocab": VOCAB, "nq": nq, "batches": n_batches,
           "k": k, "depth": depth,
           "native_analyzer": bool(native.available())}
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
    del texts
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
    eng.preplan(batches, k=k)
    t0 = time.perf_counter()
    eng.warmup(queries=batches[0], k=k)  # builds the kernel library
    sync()
    res["warmup_s"] = time.perf_counter() - t0

    # the counted main-path run; cell membership recorded per batch
    cells = []
    dispatch = eng._dispatch

    def recording_dispatch(*a, **kw):
        fut = dispatch(*a, **kw)
        cells.append(fut[1][0])  # [(query indices, bq)] per layout cell
        return fut

    eng._dispatch = recording_dispatch
    F.fused_search.launches = 0
    t0 = time.perf_counter()
    outs = list(eng.search_stream(batches, k=k, depth=depth))
    sync()
    dt = time.perf_counter() - t0
    res["launches"] = F.fused_search.launches
    eng._dispatch = dispatch
    res["serving_qps_counted_pass"] = nq * n_batches / dt
    res["layout"] = eng.plan_cache.stats()
    log(f"search_stream: {nq * n_batches} queries in {dt:.3f}s = "
        f"{res['serving_qps_counted_pass']:.1f} q/s, {res['launches']} "
        f"kernel launches, {res['layout']}")
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
        for lo in range(0, len(pick), 256):
            sel = pick[lo : lo + 256]
            p_ids, p_sc = eng.search([batch[i] for i in sel], k=k)
            np.testing.assert_array_equal(ids[sel], p_ids, f"batch {b} ids")
            np.testing.assert_array_equal(sc[sel], p_sc, f"batch {b} scores")
        n_cmp += len(pick)
        log(f"batch {b}: {len(pick)} sampled queries over {len(live)} "
            f"cells == plain scorer")
    eng.scorer = None
    res["sampled_compared"] = n_cmp

    # one batch's buckets at full size: kernel vs plain, timed
    captured = {}
    step = engine_mod._batch_step

    def capture_step(*a, **kw):
        captured["args"], captured["kw"] = a, kw
        return step(*a, **kw)

    engine_mod._batch_step = capture_step
    try:
        slot_h, coeff, rows_g, found_g = eng.frontend.analyze_rows(
            batches[0], eng.stats)
        eng._collect(eng._dispatch(slot_h, coeff, k, rows_g, found_g))
    finally:
        engine_mod._batch_step = step
    calls = bucket_calls(captured)
    res["buckets"] = [
        [int(t[0].shape[0]), p["n_blocks"], p["r_c"]] for _s, t, p in calls
    ]
    smem = F._lib().dse_smem_region_bytes()
    res["max_workspace_bytes"] = max(
        (t[0].shape[0] * p["r_c"] * 128 * 8 for _s, t, p in calls
         if p["r_c"] * 128 * 8 > smem), default=0)

    def run_kernel():
        return [F.fused_search(s.post_doc, s.post_val, *t, **p)
                for s, t, p in calls]

    got, res["kernel_ms"], res["kernel_ms_reps"] = timed(run_kernel)
    want, res["plain_ms"], res["plain_ms_reps"] = timed(
        lambda: [plain_chunks(s, t, p) for s, t, p in calls])
    for i, ((gv, gd), (wv, wd)) in enumerate(zip(got, want)):
        diff.check(gv, wv, f"main-path bucket {i} vals")
        diff.check(gd, wd, f"main-path bucket {i} docs")
    log(f"one {nq}-query batch, {len(calls)} buckets, median of "
        f"{TIMED_REPS} warm runs: kernel {res['kernel_ms']:.3f} ms, plain "
        f"{res['plain_ms']:.3f} ms, bit-identical; largest workspace "
        f"{res['max_workspace_bytes']} B")
    return res


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
    F._lib()
    log(f"kernel library built in {build_s:.1f}s: {so.name}\n"
        + so.with_suffix(".log").read_text())

    diff = Diff()
    n = phase_kernels(device, diff)
    log(f"phase 2: {n} kernel-vs-plain cases bit-identical")
    n = phase_oracle(device)
    log(f"phase 3: {n} oracle comparisons bit-identical")
    res = phase_main(device, diff)
    res["kernel_build_s"] = build_s
    print("main path: " + json.dumps(res), flush=True)
    kernels = [{
        "name": "fused_search",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": res["launches"],
        "max_abs_err": diff.max_abs,
        "ms": res["kernel_ms"],
        "plain_ms": res["plain_ms"],
    }]
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
