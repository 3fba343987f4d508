"""Host-side serving-path profile at the bench's shapes.

Port of the repo-root `tools/host_profile.py`. The card waits on the
host for most of a served batch, so this tool isolates the host's part:
it replaces the device step (module-level `engine._batch_step`) with a
dummy that returns a correctly shaped (n_real, 2k) int32 tensor on the
engine's device, then times `analyze -> _dispatch -> _collect` of one
HP_NQ-query batch over the bench's synthetic index
(`bench.build_synth_engine`, bm25, scorer "fused"), best of HP_ITERS
each, and prints a cProfile of four dispatch + collect rounds (top 24
by cumulative time).

On the card `_dispatch` reaches the step through the engine's step
graphs (engine/step_graph.py): the dummy is what its graph captures (on
the batch's first dispatch, before the timed rounds) and replays, one
fill kernel and the copy-out, so the timed dispatch is the host's
planning plus an enqueue of that graph, and the collect waits on next
to no device work. The dummy neither synchronises nor reads a tensor on
the host, as every captured step must not. Besides the original's three
stages it prints the card's `dispatch.plan` and `dispatch.enqueue`
spans (utils/prof.py; the mean of the timed rounds, recorded on the
card only) and the graphs captured. The real step is restored in a
`finally`.

    python -m document_search_engine_tpu_torch.tools.host_profile
    HP_DOCS=3000 HP_VOCAB=2000 HP_NQ=64 HP_ITERS=2 python -m \\
        document_search_engine_tpu_torch.tools.host_profile --device cpu

Env: HP_DOCS (1,000,000), HP_VOCAB (200,000), HP_NQ (8192), HP_TPQ (8),
HP_ITERS (16), HP_SPLIT ('' = off), HP_PROFILE (1 = print the cProfile
top).
"""
from __future__ import annotations

import cProfile
import io
import os
import pstats
import time

import numpy as np
import torch

from .. import bench as B
from ..config import IndexConfig, ScoringConfig
from ..engine import engine as engine_mod
from ..utils import prof

PROFILE_TOP = 24


def log(msg):
    print(msg, flush=True)


def fake_step(*a, **kw):
    """The device step's stand-in: its output's shape and type on the
    device of its inputs (a[1], the stacked rows), nothing computed."""
    return torch.ones((kw["n_real"], 2 * kw["k"]), dtype=torch.int32,
                      device=a[1].device)


def main(device=None, env=None) -> dict:
    """The profile at the HP_* knobs of `env` (default: the process's
    environment) on `device` (None: the card). Returns the best ms of
    each stage, the dispatch spans' mean ms, the ceiling q/s, the graphs
    captured and the cProfile's top entries ((function, cumulative s),
    empty with HP_PROFILE=0)."""
    env = os.environ if env is None else env
    dev = B.resolve_device(device, "host_profile")
    n_docs = int(env.get("HP_DOCS", 1_000_000))
    vocab = int(env.get("HP_VOCAB", 200_000))
    nq = int(env.get("HP_NQ", 8192))
    tpq = int(env.get("HP_TPQ", 8))
    iters = int(env.get("HP_ITERS", 16))
    split = env.get("HP_SPLIT", "")
    k = 10

    log(f"platform: {B.card_line(dev)}")
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    t0 = time.perf_counter()
    eng, df_by_row, tokens_by_row = B.build_synth_engine(
        n_docs, vocab, 60, cfg, seed=1, device=dev
    )
    eng.scorer = "fused"
    if split:
        eng.split_rows = int(split)
    log(f"[build {time.perf_counter()-t0:.1f}s]")

    rng = np.random.default_rng(7)
    eligible = np.where((df_by_row >= 64) & (df_by_row <= 32768))[0]
    rows = rng.choice(eligible, size=(nq, tpq))
    batch = [" ".join(tokens_by_row[r] for r in qr) for qr in rows]

    # --- phase 1: analysis (the native frontend; analyze_rows is the
    # production search/search_stream entry, and its rows/found let
    # _dispatch skip the per-batch segment_rows lookup)
    best_an = min(
        _t(lambda: eng.frontend.analyze_rows(batch, eng.stats))
        for _ in range(iters)
    )
    pre = eng.frontend.analyze_rows(batch, eng.stats)

    # --- phase 2+3: plan/stage (dispatch) and assemble (collect),
    # device compute replaced by a shaped dummy
    real_step = engine_mod._batch_step
    top = []
    engine_mod._batch_step = fake_step
    try:
        # converge the plan cache (and capture the dummy's graph) first
        eng._collect(eng._dispatch(pre, k))
        best_di = best_co = float("inf")
        prof.reset()
        for _ in range(iters):
            t0 = time.perf_counter()
            fut = eng._dispatch(pre, k)
            t1 = time.perf_counter()
            eng._collect(fut)
            t2 = time.perf_counter()
            best_di = min(best_di, t1 - t0)
            best_co = min(best_co, t2 - t1)
        spans = {name: prof.mean_ms(name)
                 for name in ("dispatch.plan", "dispatch.enqueue")}
        prof.reset()
        if env.get("HP_PROFILE", "1") == "1":
            pr = cProfile.Profile()
            pr.enable()
            for _ in range(4):
                eng._collect(eng._dispatch(pre, k))
            pr.disable()
            s = io.StringIO()
            st = pstats.Stats(pr, stream=s).sort_stats("cumulative")
            st.print_stats(PROFILE_TOP)
            log(s.getvalue())
            top = [(pstats.func_std_string(f), st.stats[f][3])
                   for f in st.fcn_list[:PROFILE_TOP]]
    finally:
        engine_mod._batch_step = real_step

    captures = 0 if eng._graphs is None else eng._graphs.captures
    tot = best_an + best_di + best_co
    log(
        f"host path per {nq}-query batch (best of {iters}):\n"
        f"  analyze  {best_an*1e3:7.2f} ms\n"
        f"  dispatch {best_di*1e3:7.2f} ms (plan + stage + H2D + graph "
        f"replay)\n"
        f"    dispatch.plan    {_ms(spans['dispatch.plan'])} (mean)\n"
        f"    dispatch.enqueue {_ms(spans['dispatch.enqueue'])} (mean)\n"
        f"  collect  {best_co*1e3:7.2f} ms (D2H + scatter + merge)\n"
        f"  TOTAL    {tot*1e3:7.2f} ms -> ceiling "
        f"{nq/tot:,.0f} q/s if device were free\n"
        f"  step graphs captured: {captures}"
    )
    return {
        "analyze_ms": best_an * 1e3, "dispatch_ms": best_di * 1e3,
        "collect_ms": best_co * 1e3, "total_ms": tot * 1e3,
        "plan_ms": spans["dispatch.plan"],
        "enqueue_ms": spans["dispatch.enqueue"],
        "ceiling_qps": nq / tot, "captures": captures, "profile_top": top,
    }


def _ms(v):
    return "    n/a" if v is None else f"{v:7.2f} ms"


def _t(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


if __name__ == "__main__":
    from . import device_arg

    main(device_arg("document_search_engine_tpu_torch.tools.host_profile"))
