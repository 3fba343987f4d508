#!/usr/bin/env python3
"""The device build's peak memory and time in several trees of this
repository, side by side, from one invocation on one card.

    python3 chip_build_ab.py [--out FILE] TREE [TREE ...]  # old new new old

For each TREE (a directory holding a checkout of the repository), in the
order given, one process imports that tree's
document_search_engine_tpu_torch and times, with the card's peak bytes
above each step's start (`max_memory_allocated` after
`reset_peak_memory_stats`), every path that builds or refreshes planes
on the card, at chip_smoke.py's sizes: SearchEngine.build of phase 4's
1M-doc corpus, the same segment once more with each build stage's peak
(chip_smoke.build_stage_peaks), a delete of phase 7's 100,000 ids (the
value refresh) and a compact, the streaming build in 8 batches, the
sharded device build at 1, 2, 4 and 8 shards, the bench's 1M and 8M
synthetic indexes (bench.build_synth_engine: the draw and the value
materialization) and the bench's device CSR pack of 1M docs' drawn
triples (bench.pack_triples). No kernel runs on these paths, so nothing
is compiled. Every tree is measured by this file's code and this file's
chip_smoke.py (whose functions import the package from the tree). Prints
one JSON line a tree and the card's name and power limit; with --out the
lines are written to FILE as a JSON list. Fails if a run fails.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
M8_DOCS = 8_000_000  # the bench's 8M leg (BENCH_8M_DOCS's default)


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def measure() -> dict:
    """The child: every build path of the package found first on
    sys.path (the tree it runs in)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import document_search_engine_tpu_torch as pkg
    from document_search_engine_tpu_torch import (
        DistributedSearchEngine,
        IndexConfig,
        ScoringConfig,
        SearchEngine,
        bench,
        make_mesh,
    )
    from document_search_engine_tpu_torch.corpus.loader import stream_batches

    if not torch.cuda.is_available():
        raise SystemExit("chip_build_ab: CUDA is not available")
    cs = load_chip_smoke()
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    out = {"package": os.path.dirname(pkg.__file__)}

    def step(name, fn):
        sync()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out[name] = {"s": time.perf_counter() - t0,
                     "peak_extra_bytes":
                         torch.cuda.max_memory_allocated() - m0}
        return res

    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    texts = [t for b in bench.synth_text_batches(
        cs.N_DOCS, cs.VOCAB, cs.MEAN_LEN, cs.STREAM_BATCH_DOCS) for t in b]
    eng = SearchEngine(cfg, device=dev)
    step("build", lambda: eng.build(texts))
    out["build"]["resident_bytes"] = eng.resident_bytes()
    out["build"]["postings"] = int(eng.segments[0][0].indptr[-1])
    out["build_stage_peak_bytes"] = cs.build_stage_peaks(eng)
    dead = cs.deleted_ids(np.random.default_rng(11), len(texts))
    step("delete", lambda: eng.delete_docs(dead))
    step("compact", eng.compact)
    out["compact"]["resident_bytes"] = eng.resident_bytes()
    out["compact"]["postings"] = int(eng.segments[0][0].indptr[-1])
    del eng
    seng = SearchEngine(cfg, device=dev)
    step("streaming", lambda: seng.build_streaming(
        stream_batches(texts, cs.STREAM_BATCH_DOCS)))
    out["streaming"]["resident_bytes"] = seng.resident_bytes()
    del seng
    for n in cs.SHARD_COUNTS:
        deng = DistributedSearchEngine(cfg, mesh=make_mesh(n))
        step(f"sharded_{n}", lambda: deng.build(texts))
        out[f"sharded_{n}"]["resident_bytes"] = deng.resident_bytes()
        del deng
    del texts
    torch.cuda.empty_cache()

    def synth(n_docs, seed):
        return bench.build_synth_engine(
            n_docs, max(50_000, n_docs // 5), cs.SYNTH_AVG_TERMS, cfg,
            seed=seed, device=dev)

    eng1, df1, _tok = step("synth_1m", lambda: synth(cs.SYNTH_DOCS, 1))
    out["synth_1m"]["resident_bytes"] = bench.engine_hbm_bytes(eng1)
    host0, seg0 = eng1.segments[0]
    r, d, t = bench.draw_triples(cs.SYNTH_DOCS, df1, dev)
    k_doc = torch.from_numpy(bench.builder._pad(
        bench.builder.host_k_doc(host0.dl, cfg, eng1.stats),
        seg0.n_docs_pad, 0, np.float32)).to(dev)
    step("device_pack_1m", lambda: bench.pack_triples(
        r, d, t, len(df1), cs.SYNTH_DOCS, cfg, k_doc, seg0.inv_norm,
        seg0.alive))
    out["device_pack_1m"]["triples"] = int(r.numel())
    del eng1, r, d, t, k_doc, host0, seg0
    torch.cuda.empty_cache()
    eng8, _df, _tok = step("synth_8m", lambda: synth(M8_DOCS, 2))
    out["synth_8m"]["resident_bytes"] = bench.engine_hbm_bytes(eng8)
    return out


def main(argv) -> int:
    if argv == ["--child"]:
        print(json.dumps(measure()), flush=True)
        return 0
    out_file = None
    if argv[:1] == ["--out"] and len(argv) >= 2:
        out_file, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for tree in argv:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child"],
            cwd=tree, capture_output=True, text=True,
        )
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"chip_build_ab.py failed in {tree} "
                             f"(rc {proc.returncode})")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        r.update(tree=tree, seconds=time.perf_counter() - t0)
        runs.append(r)
        print("run: " + json.dumps(r), flush=True)
    if out_file is not None:
        os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
        with open(out_file, "w") as f:
            json.dump(runs, f)
    print(load_chip_smoke().card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
