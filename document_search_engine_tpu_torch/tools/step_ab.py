"""Device-step A/B of the port's levers on one captured batch.

Port of the repo-root `tools/step_ab.py`. One process builds the bench's
index (`bench.build_synth_engine`: seed 1, 60 postings a doc, bm25,
scorer "fused"), analyzes one AB_NQ-query batch drawn as the original
draws it (`default_rng(7)`, AB_TPQ terms from the rows with 64 <= df <=
32,768), and times the device step of that batch under each lever
setting with the bench's step-only protocol (`bench.capture_step`,
`bench.step_only_qps`): the batch is dispatched through the public
`_dispatch`, then its step is run AB_ITERS times with an AB_DEPTH-deep
window and a device->host read of every output, the best of 2 such runs
kept. On the card the step is the batch's CUDA graph
(engine/step_graph.py), so a run is its replays; the host clock times
it, so a setting's ms carries the host's noise (repeat the baseline's
setting, e.g. split0, to read the spread).

Levers (STEP_AB, a comma list; '+' joins levers into one setting; every
setting is relative to the committed defaults, which the "baseline" row
times first):

  blockN     one block family of N postings: eng.block_families =
             ((None, N),)
  dv         scorer "fused_dv" (ops/fused_dv.py: one interleaved
             (X + 8, 256) doc|value plane; the planes are built once and
             held while the setting lasts, so its peak bytes hold them)
  splitN     eng.split_rows = N (doc-range splitting, one block family
             only); split0 = off, the default
  minblocksN eng.plan_min_blocks = N (a power of two; default 4)
  threadsR   ops/fused.py THREADS_BY_RC = ((R, 256), (None, 1024)): the
             largest region rows r_c launched with 256 threads, 1024
             above (default 32)
  granuleN   GRANULE_ROWS = N (ops/fused.py, and ops/schedule.py's copy):
             the planner's compaction granule, in 128-lane rows
             (default 1). The kernel stores real pairs back to back and
             reads only the slot bits of dstrow, so a coarser granule
             only sizes regions larger: the results stay bit-identical
             (tests/test_torch_tools_step_ab.py holds them on the CPU).
  tiledN     ops/fused.py TILED_MIN_RC = N: the least region rows r_c
             that the tiled kernels serve (default 256; the threshold's
             A/B, PERF.md §6)

The TPU's levers have no counterpart and exit with the reason: depthN
(the port keeps no DMA ring: every block of a query is in flight at
once), stack32 (no MAX_STACK: one thread block a query), mergeflip and
mergerev (the port merges by merge path, csrc/rank.cuh merge_runs, not a
bitonic network), ukeys and noukeys (the port always keys (doc << kb) |
slot, ops/fused.py key_bits_for). An unknown lever exits too, before the
index is built.

THREADS_BY_RC, GRANULE_ROWS, TILED_MIN_RC and plan_min_blocks are read
when a step is captured and are not part of a graph's key, as the TPU's
module constants were not part of its compile cache's. So every apply and every
restore drops the engine's graphs and takes a fresh plan-layout cache
(the counterpart of the original's jax.clear_caches()), and each setting
must capture at least one graph. Gates the original lacks: every
setting's batch ids and scores equal the baseline's (torch.equal), and
the module constants and engine fields are restored in a `finally`.

    python -m document_search_engine_tpu_torch.tools.step_ab
    AB_DOCS=3000 AB_VOCAB=2000 AB_NQ=64 AB_ITERS=2 python -m \\
        document_search_engine_tpu_torch.tools.step_ab --device cpu

Env: AB_DOCS (1,000,000), AB_VOCAB (200,000), AB_NQ (8192), AB_TPQ (8),
AB_ITERS (24), AB_DEPTH (8), STEP_AB (block2048,split128,threads16,
threads64). k is 10.
"""
from __future__ import annotations

import os
import re
import time

import numpy as np
import torch

from .. import bench as B
from ..config import IndexConfig, ScoringConfig
from ..ops import fused as F
from ..ops import schedule as S
from ..ops.plan_cache import PlanLayoutCache

DEFAULT_LEVERS = "block2048,split128,threads16,threads64"
K = 10
PASSES = 2  # timed runs a setting, the best kept (the original's)

# the TPU's levers, and why the port has none of them
TPU_ONLY = (
    (r"depth\d+", "the port has no DMA depth: every block of a query is "
     "in flight at once (csrc/fused_search.cu)"),
    (r"stack32", "the port has no MAX_STACK: one thread block a query"),
    (r"merge(flip|rev)", "the port merges by merge path (csrc/rank.cuh "
     "merge_runs), not a bitonic network"),
    (r"(no)?ukeys", "the port always keys (doc << kb) | slot "
     "(ops/fused.py key_bits_for)"),
)
LEVER = re.compile(
    r"(block|split|minblocks|threads|granule|tiled)(\d+)|dv")


def log(msg):
    print(msg, flush=True)


def check_levers(spec: str) -> list:
    """The settings of a STEP_AB list; exits on a TPU-only or unknown
    lever."""
    names = [n for n in spec.split(",") if n]
    for name in names:
        for part in name.split("+"):
            for pat, why in TPU_ONLY:
                if re.fullmatch(pat, part):
                    raise SystemExit(f"lever {part!r}: {why}")
            if not LEVER.fullmatch(part):
                raise SystemExit(f"unknown lever {part!r}")
    return names


def snapshot(eng) -> dict:
    """The module constants and engine fields the levers change."""
    return dict(
        threads=F.THREADS_BY_RC, granule=(F.GRANULE_ROWS, S.GRANULE_ROWS),
        tiled=F.TILED_MIN_RC, families=eng.block_families, scorer=eng.scorer,
        split=eng.split_rows, min_blocks=eng.plan_min_blocks,
    )


def restore(eng, snap: dict) -> None:
    F.THREADS_BY_RC = snap["threads"]
    F.GRANULE_ROWS, S.GRANULE_ROWS = snap["granule"]
    F.TILED_MIN_RC = snap["tiled"]
    eng.block_families = snap["families"]
    eng.scorer = snap["scorer"]
    eng.split_rows = snap["split"]
    eng.plan_min_blocks = snap["min_blocks"]
    fresh_step(eng)


def fresh_step(eng) -> None:
    """Drop what was captured or planned under other constants: the step
    graphs, the plan layouts and the dv planes."""
    eng.plan_cache = PlanLayoutCache()
    if eng._graphs is not None:
        eng._graphs.clear()
    eng._dv_cache.clear()


def apply(eng, name: str) -> None:
    """Set the levers of one setting (check_levers has vetted it)."""
    for part in name.split("+"):
        m = LEVER.fullmatch(part)
        what, n = m.group(1), int(m.group(2) or 0)
        if part == "dv":
            eng.scorer = "fused_dv"
        elif what == "block":
            eng.block_families = ((None, n),)
        elif what == "split":
            eng.split_rows = n if n > 0 else None
        elif what == "minblocks":
            eng.plan_min_blocks = n
        elif what == "threads":
            F.THREADS_BY_RC = ((n, 256), (None, 1024))
        elif what == "tiled":
            F.TILED_MIN_RC = n
        else:
            F.GRANULE_ROWS = S.GRANULE_ROWS = n
    fresh_step(eng)


def main(device=None, env=None, built=None) -> dict:
    """The A/B at the AB_* and STEP_AB knobs of `env` (default: the
    process's environment) on `device` (None: the card). `built` is the
    bench index as (engine, df_by_row, tokens_by_row) from
    bench.build_synth_engine, made here when None; its engine is left as
    it was given but for its graphs and plan layouts, which are dropped.
    Returns the card line, nq and one dict a setting (name, ms a batch,
    q/s, graphs captured, peak device bytes above the allocated bytes at
    the setting's start (None on the CPU)); raises if a setting's results
    differ from the baseline's or a setting on the card captured no
    graph."""
    env = os.environ if env is None else env
    dev = B.resolve_device(device, "step_ab")
    n_docs = int(env.get("AB_DOCS", 1_000_000))
    vocab = int(env.get("AB_VOCAB", 200_000))
    nq = int(env.get("AB_NQ", 8192))
    tpq = int(env.get("AB_TPQ", 8))
    iters = int(env.get("AB_ITERS", 24))
    depth = int(env.get("AB_DEPTH", 8))
    levers = check_levers(env.get("STEP_AB", DEFAULT_LEVERS))

    card = B.card_line(dev)
    log(f"platform: {card}")
    if built is None:
        cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
        built = B.build_synth_engine(n_docs, vocab, 60, cfg, seed=1,
                                     device=dev)
    eng, df_by_row, tokens_by_row = built

    rng = np.random.default_rng(7)
    eligible = np.where((df_by_row >= 64) & (df_by_row <= 32768))[0]
    rows = rng.choice(eligible, size=(nq, tpq))
    batch = [" ".join(tokens_by_row[r] for r in qr) for qr in rows]
    pre = eng.frontend.analyze(batch, eng.stats)

    snap = snapshot(eng)
    results, base = [], None
    try:
        eng.scorer = "fused"
        snap_fused = snapshot(eng)
        for name in ["baseline", *levers]:
            t0 = time.perf_counter()
            if name != "baseline":
                apply(eng, name)
            else:
                fresh_step(eng)
            row = _time_setting(eng, dev, pre, iters, depth, nq, name)
            out = row.pop("out")
            if base is None:
                base = out
            elif not all(torch.equal(torch.from_numpy(g), torch.from_numpy(w))
                         for g, w in zip(out, base)):
                raise AssertionError(f"step_ab {name}: ids or scores "
                                     "differ from the baseline's")
            if eng._graphs is not None and row["captures"] < 1:
                raise AssertionError(f"step_ab {name}: no graph captured")
            rel = (results[0]["ms"] / row["ms"] - 1) * 100 if results else 0.0
            results.append(row)
            log(f"{name}: {row['ms']:.2f} ms/batch -> {row['qps']:,.0f} q/s "
                f"({rel:+.1f}% vs baseline); {row['captures']} graphs "
                f"captured; peak {row['peak_bytes']} B; "
                f"[{time.perf_counter() - t0:.1f}s]")
            restore(eng, snap_fused)
    finally:
        restore(eng, snap)
    log(f"results: {[(r['name'], round(r['ms'], 2)) for r in results]}")
    return {"card": card, "nq": nq, "iters": iters, "results": results}


def _time_setting(eng, dev, pre, iters, depth, nq, name) -> dict:
    """One setting's step-only run: ms a batch, q/s, the graphs it
    captured, its peak device bytes above the start, its (ids, scores)."""
    cuda = dev.type == "cuda"
    captures = 0 if eng._graphs is None else eng._graphs.captures
    if cuda:
        B.sync(dev)
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    qps = 0.0
    for _p in range(PASSES):
        got, out = B.step_only_qps(eng, pre, K, iters, depth, nq, name)
        qps = max(qps, got)
    return {
        "name": name, "ms": nq / qps * 1e3, "qps": qps,
        "captures": (0 if eng._graphs is None
                     else eng._graphs.captures - captures),
        "peak_bytes": (torch.cuda.max_memory_allocated(dev) - start
                       if cuda else None),
        "out": out,
    }


if __name__ == "__main__":
    from . import device_arg

    main(device_arg("document_search_engine_tpu_torch.tools.step_ab"))
