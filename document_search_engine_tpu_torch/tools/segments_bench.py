"""Multi-segment serving curve: what segment fragmentation costs.

Port of the repo-root `tools/segments_bench.py`. Builds the SAME corpus
as 1, 2, 4, 8 and 16 streaming segments (one segment per batch of
`build_streaming`, auto-compact off so the fragmentation survives), then
times the public serving loop (`search_stream`, k 10, depth 8) at each
count: `preplan`, one warm-up pass (on the card it captures the batch's
step graph), then the best of 2 timed passes of SEG_ITERS batches.
Every count must return the 1-segment results (the global df refresh
makes fragmentation invisible); a count that does not raises.

Each (segment x bucket) pair adds a kernel launch to the batch's step
graph, and over several segments the step merges their top-k
(ops/segment_merge.py, one more launch), so the curve measures what the
lifecycle policy's `auto_compact_segments` (engine/engine.py) trades.
Beside the q/s each count prints the step graphs held
(`len(eng._graphs)`; none on the CPU), the kernel launches a batch (and
the merge's launches in the timed pass: one a batch over several
segments on the card), the host ms a batch of `dispatch.plan` and
`dispatch.enqueue`
(utils/prof.py), the peak device bytes above the count's start, the
allocator's peak reserved bytes and the graph pool's bytes (the spans
and the bytes on the card only).

    python -m document_search_engine_tpu_torch.tools.segments_bench
    SEG_DOCS=600 SEG_VOCAB=400 SEG_NQ=64 SEG_ITERS=2 SEG_COUNTS=1,2,4 \\
        python -m document_search_engine_tpu_torch.tools.segments_bench \\
        --device cpu

Env: SEG_DOCS (96000), SEG_VOCAB (30000), SEG_NQ (8192), SEG_ITERS
(16), SEG_COUNTS (1,2,4,8,16), SEG_KIND (bm25).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..bench import card_line, launch_counts, resolve_device
from ..config import IndexConfig, ScoringConfig
from ..corpus.synth import synth_corpus, synth_queries
from ..engine.engine import SearchEngine
from ..utils import prof

K, DEPTH, MEAN_LEN = 10, 8, 120


def log(msg):
    print(msg, flush=True)


def run(device, n_docs, vocab, nq, iters, counts, kind) -> dict:
    """The curve on `device`. Returns {"curve": {count: q/s}, "per_count":
    {count: readings}, "docs", "queries", "ids", "scores"}: the corpus,
    its queries and the results every count returned."""
    dev = resolve_device(device, "segments_bench")
    log(f"platform: {card_line(dev)}")
    t0 = time.perf_counter()
    docs = synth_corpus(
        n_docs=n_docs, vocab_size=vocab, mean_len=MEAN_LEN, seed=11
    )
    queries = synth_queries(docs, n_queries=nq, terms_per_query=8, seed=12)
    log(f"corpus: {n_docs} docs vocab~{vocab} + {nq} queries "
        f"({time.perf_counter()-t0:.1f}s)")
    batches = [queries]  # one canonical batch shape, reused

    results, per_count = {}, {}
    ref_ids = ref_sc = None
    for n_seg in counts:
        cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
        eng = SearchEngine(cfg, device=dev)
        eng.auto_compact_segments = None  # keep the fragmentation
        eng.auto_compact_dead_frac = None
        chunk = -(-n_docs // n_seg)
        t0 = time.perf_counter()
        eng.build_streaming(
            docs[i : i + chunk] for i in range(0, n_docs, chunk)
        )
        t_build = time.perf_counter() - t0
        if len(eng.segments) != n_seg:
            raise AssertionError(
                f"{len(eng.segments)} segments built, not {n_seg}")
        mem0 = _reset_peak(dev)
        t0 = time.perf_counter()
        eng.preplan(batches, k=K)
        ids = sc = None
        for ids, sc in eng.search_stream(iter(batches), k=K, depth=DEPTH):
            pass
        t_warm = time.perf_counter() - t0
        # fragmentation must not change results (global df refresh)
        if ref_ids is None:
            ref_ids, ref_sc = ids, sc
        elif not (np.array_equal(ids, ref_ids)
                  and np.array_equal(sc, ref_sc)):
            raise AssertionError(f"{n_seg}-segment results diverged")
        best, reading = 0.0, None
        for _p in range(2):
            prof.reset()
            before = launch_counts()
            t0 = time.perf_counter()
            n_out = 0
            for ids, _s in eng.search_stream(
                (batches[0] for _ in range(iters)), k=K, depth=DEPTH
            ):
                n_out += len(ids)
            dt = time.perf_counter() - t0
            if n_out != nq * iters:
                raise AssertionError(f"{n_out} results, not {nq * iters}")
            if nq * iters / dt > best:
                best = nq * iters / dt
                after = launch_counts()
                reading = {
                    "launches_per_batch":
                        (sum(after.values()) - sum(before.values())) / iters,
                    "batches": iters,
                    "merge_launches":
                        after["segment_merge"] - before["segment_merge"],
                    # recorded on the card only (None on the CPU)
                    "plan_ms": prof.mean_ms("dispatch.plan"),
                    "enqueue_ms": prof.mean_ms("dispatch.enqueue"),
                }
        prof.reset()
        results[n_seg] = best
        per_count[n_seg] = {
            "qps": best, "build_s": t_build, "warm_s": t_warm,
            "graphs": 0 if eng._graphs is None else len(eng._graphs),
            **reading, **_peaks(dev, mem0, eng),
            "plan_cache": eng.plan_cache.stats(),
        }
        r = per_count[n_seg]
        log(
            f"segments={n_seg:>2}: {best:,.0f} q/s "
            f"(build {t_build:.1f}s, capture+warmup {t_warm:.1f}s, "
            f"graphs {r['graphs']}, launches a batch "
            f"{r['launches_per_batch']:g} (merge {r['merge_launches']} in "
            f"{r['batches']} batches), dispatch.plan "
            f"{_ms(r['plan_ms'])}, dispatch.enqueue {_ms(r['enqueue_ms'])} "
            f"a batch, peak device memory {r['peak_bytes']} B above the "
            f"start (reserved {r['reserved_bytes']} B, graph pool "
            f"{r['pool_bytes']} B), plan cache: {r['plan_cache']})"
        )
        del eng

    base = results.get(counts[0], 1.0)
    log("curve: " + json.dumps(
        {str(n): round(q, 1) for n, q in results.items()}
    ))
    log("relative: " + ", ".join(
        f"{n}seg={results[n]/base*100:.0f}%" for n in counts
    ))
    return {"curve": results, "per_count": per_count, "docs": docs,
            "queries": queries, "ids": ref_ids, "scores": ref_sc}


def _ms(v):
    return "n/a" if v is None else f"{v:.2f} ms"


def _reset_peak(dev):
    """Start a count's memory readings (the card's only): the allocated
    bytes now, with the peaks reset."""
    if dev.type != "cuda":
        return None
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _peaks(dev, mem0, eng) -> dict:
    """A count's peak allocated bytes above its start, the allocator's
    peak reserved bytes and the step graphs' pool bytes, over its
    warm-up (captures in) and timed passes; None on the CPU."""
    if dev.type != "cuda":
        return {"peak_bytes": None, "reserved_bytes": None,
                "pool_bytes": None}
    return {"peak_bytes": torch.cuda.max_memory_allocated(dev) - mem0,
            "reserved_bytes": torch.cuda.max_memory_reserved(dev),
            "pool_bytes": eng._graphs.pool_bytes()}


def main(device=None, env=None) -> dict:
    """The curve (run) at the SEG_* knobs of `env` (default: the
    process's environment) on `device` (None: the card)."""
    env = os.environ if env is None else env
    return run(
        device,
        n_docs=int(env.get("SEG_DOCS", 96000)),
        vocab=int(env.get("SEG_VOCAB", 30000)),
        nq=int(env.get("SEG_NQ", 8192)),
        iters=int(env.get("SEG_ITERS", 16)),
        counts=[int(c) for c in env.get("SEG_COUNTS", "1,2,4,8,16")
                .split(",")],
        kind=env.get("SEG_KIND", "bm25"),
    )


if __name__ == "__main__":
    from . import device_arg

    main(device_arg("document_search_engine_tpu_torch.tools.segments_bench"))
