"""Randomized differential fuzz: the port's engines against its frozen
oracle across configuration dimensions the fixed tests do not fully
compose: scoring kind x k x scorer x split_rows x shard count x a random
lifecycle (add/delete/compact), asserting bit-identical ids AND integer
scores after the build and after every step.

Port of the repo-root `tools/fuzz_differential.py`: a seed draws the
same trial in both (the same draws from `np.random.default_rng(seed)` in
the same order: docs, vocab, mean length, kind, k, scorer, split, shards,
the initial docs, the queries, then each lifecycle step), and the trial
prints the same description. Neither fuzzes save/load or the fused_dv
scorer. On the card each search goes through the engines' step graphs
(engine/step_graph.py), so a trial's history also drives their capture,
replay and release on every mutation; shard counts 1, 2 and 4 put every
shard on the one card (make_mesh).

    python -m document_search_engine_tpu_torch.tools.fuzz_differential
    FUZZ_TRIALS=100 FUZZ_SEED=7 python -m \\
        document_search_engine_tpu_torch.tools.fuzz_differential --device cpu

Env: FUZZ_TRIALS (20), FUZZ_SEED (the clock's seconds mod 100,000);
trial i runs seed FUZZ_SEED + 101 i. Raises on the first mismatch with
a repro line (the trial's description).
"""
from __future__ import annotations

import os
import time

import numpy as np

from ..bench import launch_counts, resolve_device
from ..config import IndexConfig, ScoringConfig
from ..corpus.synth import synth_corpus, synth_queries
from ..engine.engine import SearchEngine
from ..oracle import OracleEngine
from ..parallel.dist import DistributedSearchEngine
from ..parallel.mesh import make_mesh

SEED_STRIDE = 101


def draw_config(rng) -> dict:
    """A trial's configuration, the first draws of its seed's stream."""
    return {
        "n_docs": int(rng.integers(30, 260)),
        "vocab": int(rng.integers(80, 900)),
        "mean_len": int(rng.integers(8, 60)),
        "kind": str(rng.choice(["tfidf", "bm25"])),
        "k": int(rng.choice([1, 3, 10, 37, 100])),
        "scorer": str(rng.choice(["fused", "xla", "xla_rank"])),
        "split": rng.choice([None, 2, 4, 16]),
        "n_shards": int(rng.choice([0, 0, 1, 2, 4])),  # 0 = single engine
    }


def trial_config(seed: int) -> dict:
    """The configuration seed `seed` draws, without running the trial."""
    return draw_config(np.random.default_rng(seed))


def describe(seed: int, c: dict) -> str:
    return (
        f"seed={seed} docs={c['n_docs']} vocab={c['vocab']} "
        f"len={c['mean_len']} kind={c['kind']} k={c['k']} "
        f"scorer={c['scorer']} split={c['split']} shards={c['n_shards']}"
    )


def run_trial(seed: int, device=None):
    """One trial on `device` (None: the card). Returns (description,
    engine); raises AssertionError on a mismatch."""
    dev = resolve_device(device, "fuzz_differential")
    rng = np.random.default_rng(seed)
    c = draw_config(rng)
    n_docs, k = c["n_docs"], c["k"]
    desc = describe(seed, c)

    docs = synth_corpus(
        n_docs=n_docs, vocab_size=c["vocab"], mean_len=c["mean_len"],
        seed=seed,
    )
    queries = synth_queries(
        docs, n_queries=int(rng.integers(3, 12)),
        terms_per_query=int(rng.integers(1, 7)), seed=seed + 1,
    ) + ["", "qqqmissing zz"]

    cfg = IndexConfig(scoring=ScoringConfig(kind=c["kind"]))
    orc = OracleEngine(cfg)
    if c["n_shards"]:
        eng = DistributedSearchEngine(
            cfg, mesh=make_mesh(c["n_shards"], device=dev))
    else:
        eng = SearchEngine(cfg, device=dev)
    eng.scorer = c["scorer"]
    if c["split"] is not None:
        eng.split_rows = int(c["split"])

    n0 = max(2, n_docs - int(rng.integers(0, n_docs // 2)))
    orc.build(docs[:n0])
    eng.build(docs[:n0])

    def check(tag):
        oid, osc = orc.search(queries, k=k)
        gid, gsc = eng.search(queries, k=k)
        if not (np.array_equal(oid, gid) and np.array_equal(osc, gsc)):
            bad = np.nonzero(
                ~((oid == gid).all(1) & (osc == gsc).all(1))
            )[0][:3]
            raise AssertionError(
                f"{desc} [{tag}] mismatch rows {bad.tolist()}:\n"
                f"  oracle ids {oid[bad]}\n  engine ids {gid[bad]}\n"
                f"  oracle sc  {osc[bad]}\n  engine sc  {gsc[bad]}"
            )

    check("build")
    pending = list(docs[n0:])
    n_total = n0  # global ids are dense over every doc ever added
    alive = set(range(n0))
    for step in range(int(rng.integers(2, 6))):
        op = rng.choice(["add", "delete", "compact", "search"])
        if op == "add" and pending:
            take = int(rng.integers(1, min(8, len(pending)) + 1))
            orc.add_docs(pending[:take])
            eng.add_docs(pending[:take])
            alive |= set(range(n_total, n_total + take))
            n_total += take
            pending = pending[take:]
        elif op == "delete" and len(alive) > 2:
            dead = rng.choice(sorted(alive),
                              size=min(3, len(alive) - 1), replace=False)
            orc.delete_docs([int(d) for d in dead])
            eng.delete_docs([int(d) for d in dead])
            alive -= set(int(d) for d in dead)
        elif op == "compact":
            eng.compact()
        check(f"step{step}:{op}")
    return desc, eng


def one_trial(seed: int, device=None) -> str:
    """One trial (run_trial); returns its description."""
    return run_trial(seed, device)[0]


def run_trials(base: int, trials: int, device=None) -> dict:
    """Trials base + 101 i for i < trials, printing one line each.
    Returns the seconds, the step graphs' captures (0 on the CPU), the
    kernels' launches during the trials (the counters count CUDA
    launches only) and each trial's configuration."""
    print(f"differential fuzz: {trials} trials, base seed {base}",
          flush=True)
    before = launch_counts()
    captures = 0
    configs = []
    t0 = time.perf_counter()
    for i in range(trials):
        seed = base + i * SEED_STRIDE
        desc, eng = run_trial(seed, device)
        if eng._graphs is not None:
            captures += eng._graphs.captures
        configs.append(trial_config(seed))
        print(f"  ok {i + 1}/{trials}: {desc} "
              f"[{time.perf_counter() - t0:.0f}s]", flush=True)
    seconds = time.perf_counter() - t0
    print(f"ALL {trials} TRIALS PASSED in {seconds:.0f}s", flush=True)
    return {
        "trials": trials, "base_seed": base, "seconds": seconds,
        "captures": captures,
        "launches": {name: n - before[name]
                     for name, n in launch_counts().items()},
        "configs": configs,
    }


def main(device=None, env=None) -> dict:
    """FUZZ_TRIALS trials from FUZZ_SEED (run_trials) on `device`;
    `env` defaults to the process's environment."""
    env = os.environ if env is None else env
    trials = int(env.get("FUZZ_TRIALS", 20))
    base = int(env.get("FUZZ_SEED", int(time.time()) % 100000))
    return run_trials(base, trials, device)


if __name__ == "__main__":
    from . import device_arg

    main(device_arg("document_search_engine_tpu_torch.tools.fuzz_differential"))
