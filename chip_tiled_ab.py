#!/usr/bin/env python3
"""End-to-end A/B of the tiled kernels' constants and of thread placement,
interleaved in one process on one benchmark cell.

    python3 chip_tiled_ab.py CELL SEED WINDOW_S ROUNDS LEG LEG [LEG ...]

Draws and builds the cell as `benchmark.run` does (benchmark/gen, the
cell's configuration and traffic), then serves its closed loop in windows
of WINDOW_S seconds, the legs in turns (A B, then B A, ...) for ROUNDS
rounds, so that drift of the host or the card shows as a difference
between the windows of one leg. A leg is

  tree       the kernel library as this tree builds it;
  wLtT       a library built from a copy of csrc/ whose
             csrc/fused_tiled.cu has kTileLog2 = L and kTilesPerBlock = T
             (a tile of 2**L docs, T tiles a thread block); its copies
             in ops/tiled.py are swapped in with it;
  pin        the tree's library, the main thread and search_stream's
             analysis worker each held to a core of its own (the process's
             third and fifth allowed cores).

Each leg has step graphs of its own (StepGraphs.fresh()), captured in a
warm pass before the first window. Per window: q/s, the 95th percentile
of batch latency, the mean of every serving span (utils/prof.py) and the
process's CPU ms a batch. Fails unless every leg answers the pool's first
batch with the same ids and scores. Each row goes to stderr as it comes;
the last line on stdout is the whole result, JSON.
"""
from __future__ import annotations

import json
import os
import re
import resource
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SPANS = ("stream.analyze", "stream.wait_analysis", "dispatch.plan",
         "dispatch.enqueue", "collect.wait", "collect.assemble")
LEG = re.compile(r"tree|pin|w(\d+)t(\d+)")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parse_legs(names) -> list:
    """The legs named on the command line; exits on an unknown one."""
    for name in names:
        if not LEG.fullmatch(name):
            raise SystemExit(f"unknown leg {name!r}: tree, pin or wLtT")
    if len(set(names)) != len(names) or len(names) < 2:
        raise SystemExit("give two or more distinct legs")
    return list(names)


def tile_source(text: str, log2: int, tpb: int) -> str:
    """csrc/fused_tiled.cu with its tile constants replaced."""
    for name, value in (("kTileLog2", log2), ("kTilesPerBlock", tpb)):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"csrc/fused_tiled.cu: no {name}")
    return text


def tile_library(F, log2: int, tpb: int, scratch: Path):
    """A kernel library whose tiled kernels take a tile of 2**log2 docs
    and tpb tiles a block, loaded beside the tree's."""
    src = scratch / f"csrc_w{log2}t{tpb}"
    shutil.copytree(F.CSRC, src)
    cu = src / "fused_tiled.cu"
    cu.write_text(tile_source(cu.read_text(), log2, tpb))
    saved = (F.CSRC, F.BUILD_DIR, F._lib_handle)
    F.CSRC, F.BUILD_DIR, F._lib_handle = src, src / "_build", None
    try:
        return F._lib()
    finally:
        F.CSRC, F.BUILD_DIR, F._lib_handle = saved


def main(argv) -> int:
    if len(argv) < 6:
        raise SystemExit(__doc__)
    cell, seed, win, rounds = argv[0], int(argv[1]), float(argv[2]), int(
        argv[3])
    legs = parse_legs(argv[4:])
    # one OpenMP thread, as benchmark/run.py sets it, before numpy and
    # torch load
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    from benchmark import run as RUN
    from benchmark.gen.corpus import draw_corpus
    from benchmark.gen.queries import Pool
    from benchmark.registry import Registry
    from document_search_engine_tpu_torch.ops import fused as F
    from document_search_engine_tpu_torch.ops import tiled as T
    from document_search_engine_tpu_torch.utils import prof

    if not torch.cuda.is_available():
        raise SystemExit("chip_tiled_ab: CUDA is not available")
    reg = Registry()
    wl = reg.workload(cell)
    cfg, traffic = reg.config(wl["config"]), reg.traffic(wl["traffic"])
    serve = reg.loop(traffic["loop"])
    k = int(traffic["k"])
    t0 = time.time()
    corpus = draw_corpus(cfg, seed, "cuda")
    pool = Pool(cfg, traffic, corpus, seed)
    eng = RUN.make_engine(cfg, "cuda")
    texts, corpus.texts = corpus.texts, None
    eng.build(texts)
    del texts
    log(f"{cell}: built in {time.time() - t0:.1f} s")

    cores = sorted(os.sched_getaffinity(0))
    pinned = {"on": False}
    analyze_rows = eng.frontend.analyze_rows

    def placed_analyze_rows(*a, **kw):
        if pinned["on"]:
            os.sched_setaffinity(0, {cores[4 % len(cores)]})
        return analyze_rows(*a, **kw)

    eng.frontend.analyze_rows = placed_analyze_rows
    scratch = Path(tempfile.mkdtemp(prefix="tiled_ab_"))
    tree = (F._lib(), T.TILE_DOCS, T.TILES_PER_BLOCK)
    setup = {}
    for name in legs:
        m = LEG.fullmatch(name)
        if m.group(1):
            log2, tpb = int(m.group(1)), int(m.group(2))
            setup[name] = (tile_library(F, log2, tpb, scratch), 1 << log2,
                           tpb)
        else:
            setup[name] = tree
    graphs = {name: eng._graphs.fresh() for name in legs}

    def use(name):
        F._lib_handle, T.TILE_DOCS, T.TILES_PER_BLOCK = setup[name]
        eng._graphs = graphs[name]
        pinned["on"] = name == "pin"
        os.sched_setaffinity(0, {cores[2 % len(cores)]} if pinned["on"]
                             else set(cores))

    eng.preplan(pool.batches, k=k)
    answers = []
    for name in legs:
        use(name)
        serve(eng, pool, traffic, pool.order)  # captures the leg's graphs
        answers.append(tuple(map(np.asarray, eng.search(pool.batches[0],
                                                         k=k))))
    same = all(np.array_equal(a[0], answers[0][0])
               and np.array_equal(a[1], answers[0][1]) for a in answers)
    log(f"legs' answers bit-identical: {same}")
    rows = []
    for r in range(rounds):
        for name in legs if r % 2 == 0 else legs[::-1]:
            use(name)
            prof.reset()
            ru0 = resource.getrusage(resource.RUSAGE_SELF)
            pulls, lat, t_end = serve(eng, pool, traffic, pool.order,
                                      time.perf_counter() + win)
            ru1 = resource.getrusage(resource.RUSAGE_SELF)
            cpu = (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime
                                                   - ru0.ru_stime)
            row = {"leg": name,
                   "qps": len(lat) * pool.batch / (t_end - pulls[0][1]),
                   "p95_ms": float(np.percentile(np.array(lat) * 1e3, 95)),
                   "batches": len(lat), "cpu_ms_a_batch": cpu / len(lat)
                   * 1e3}
            row.update({s: prof.mean_ms(s) for s in SPANS})
            rows.append(row)
            log(json.dumps(row))
    use(legs[0])
    shutil.rmtree(scratch, ignore_errors=True)
    print(json.dumps({"cell": cell, "seed": seed,
                      "card": torch.cuda.get_device_name(0), "same": same,
                      "rows": rows}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
