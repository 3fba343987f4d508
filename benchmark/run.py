"""One run of one cell of the port's benchmark.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

In order: draw the cell's corpus and query pool from the seed (gen/);
set the index up by the configuration's set-up (setups/<its "setup"
name>.py; setups/single.py, one `SearchEngine.build` from the texts,
where it names none), which returns the live documents; warm up on the
cell's own traffic (`preplan` over the pool, then one pass of
`search_stream`, which captures every plan layout's step graph and loads
the kernel library); drive `search_stream` for `--seconds` over the
pool's batches, round and round, by the mix's loop (loops/); then, with
the engine freed, rank the sampled queries with the configuration's plain
reference (reference/) over the live documents and compare. The last
line on stdout is the result, JSON; the last lines on stderr are the
numbers compared, each beside its limit.

With `--trace 0` the result's metrics are the cell's end-to-end metrics.
With `--trace 1` the window runs under the program's profiler trace
(utils/prof.py), and ends after TRACE_BATCHES batches if `--seconds` has
not ended it first; the result carries the per-layer metrics, each read
by its reader in metrics/, and the device's busy and window seconds.

The program is driven only through its public API: `SearchEngine`,
`.build`, `.build_streaming`, `.delete_docs`, the lifecycle policy's
`.auto_compact_segments` and `.auto_compact_dead_frac`,
`len(.segments)`, `.preplan`, `.search_stream`, `.resident_bytes` and
`utils/prof.py`.
"""
from __future__ import annotations

import os
import time


def process_start() -> float:
    """Wall-clock time at which this process started (from /proc), or
    now where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = process_start()
# One OpenMP thread in this process, set before numpy and torch load: the
# program's host work is many small torch and numpy calls, and a pool of
# OpenMP threads beside the main thread and the analysis worker spread
# the runs of a host-bound mix by 15% (PERF.md, section 2).
os.environ["OMP_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "document_search_engine_tpu")
# a traced window ends after this many batches, if `--seconds` has not
# ended it first: every batch adds some 0.8 MB of trace events
TRACE_BATCHES = 128
GIB = 1 << 30


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run may not load, compared
    whole (the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def make_engine(cfg: dict, device):
    from document_search_engine_tpu_torch import (
        IndexConfig,
        ScoringConfig,
        SearchEngine,
    )

    sc = cfg["scoring"]
    config = IndexConfig(
        scoring=ScoringConfig(kind=sc["kind"], k1=sc["k1"], b=sc["b"],
                              scale_bits=sc["scale_bits"]),
        max_query_terms=cfg["max_query_terms"],
    )
    return SearchEngine(config, device=device)


def compare(answers: dict, sample, ref_ids, ref_scores) -> dict:
    """The numbers compared: sampled answers of the window that differ
    from the reference in any id or score, and how many were compared."""
    wrong = compared = 0
    for i, q in enumerate(sample):
        for ids, scores in answers.get(int(q), []):
            compared += 1
            if not (np.array_equal(ids, ref_ids[i])
                    and np.array_equal(scores, ref_scores[i])):
                wrong += 1
    return {
        "wrong_answers": {"value": wrong, "limit": 0, "rule": "<="},
        "answers_compared": {"value": compared, "limit": 1, "rule": ">="},
    }


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] if c["rule"] == "<="
               else c["value"] >= c["limit"] for c in checks.values())


def window_counts(pool, ref, corpus, pulls, k: int, peaks) -> float:
    """Least seconds (roofline.py) of the window's batches, from the
    pool's term ids and the df of the live documents as the reference
    counted them: the postings that a compacted index would read."""
    from . import roofline

    cls = ref.cls_of_index[corpus.perm[pool.ranks]]
    least = []
    for j in range(pool.n_batches):
        q0 = j * pool.batch
        terms = [np.unique(cls[pool.ptr[q]:pool.ptr[q + 1]])
                 for q in range(q0, q0 + pool.batch)]
        least.append(roofline.least_seconds(
            roofline.batch_counts(terms, ref.df, k), peaks))
    return float(sum(least[j] for j, _t in pulls))


def run_cell(reg, name: str, seed: int, seconds: float, trace: bool,
             device="cuda") -> dict:
    """One run of cell `name` on `device`: the result line's object."""
    import torch

    from document_search_engine_tpu_torch.utils import prof

    from . import roofline
    from . import trace as trace_mod
    from .gen.corpus import draw_corpus
    from .gen.queries import Pool
    from .registry import setup_of

    cuda = torch.device(device).type == "cuda"
    wl = reg.workload(name)
    cfg = reg.config(wl["config"])
    traffic = reg.traffic(wl["traffic"])
    serve = reg.loop(traffic["loop"])
    build = reg.setup(setup_of(cfg)["name"])
    Reference = reg.reference(cfg["scoring"]["kind"])
    k = int(traffic["k"])

    t = time.time()
    corpus = draw_corpus(cfg, seed, device)
    pool = Pool(cfg, traffic, corpus, seed)
    log(f"drawn: {corpus.n_docs} docs, {corpus.ranks.size} tokens, "
        f"V {corpus.vocab}, {pool.n_batches} x {pool.batch} queries "
        f"({pool.ranks.size} terms) in {time.time() - t:.3f} s")
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    t = time.time()
    eng = make_engine(cfg, device)
    texts, corpus.texts = corpus.texts, None
    alive = build(eng, texts, cfg, seed)
    del texts
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
    log(f"built: {time.time() - t:.3f} s, resident "
        f"{eng.resident_bytes()} B")

    t = time.time()
    eng.preplan(pool.batches, k=k)
    serve(eng, pool, traffic, pool.order)
    log(f"warmed: {time.time() - t:.3f} s")

    by_batch = {}
    for q in pool.sample:
        by_batch.setdefault(int(q) // pool.batch, []).append(int(q))
    answers: dict = {}

    def keep(j, ids, scores):
        for q in by_batch.get(j, ()):
            r = q % pool.batch
            answers.setdefault(q, []).append((ids[r].copy(),
                                              scores[r].copy()))

    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    trace_path = os.path.join(tempfile.gettempdir(),
                              f"benchmark-{name}-trace.json")

    def window(max_batches=None):
        """The measured window; returns set-up seconds (process start to
        the window's start) and serve's readings."""
        prof.reset()
        setup = time.time() - T_PROCESS
        return setup, serve(eng, pool, traffic, pool.order,
                            time.perf_counter() + seconds, keep, max_batches)

    if trace:
        with prof.trace(trace_path):
            with torch.profiler.record_function(trace_mod.WINDOW):
                setup_s, (pulls, lat, t_end) = window(TRACE_BATCHES)
                if cuda:
                    torch.cuda.synchronize()
    else:
        setup_s, (pulls, lat, t_end) = window()
    window_s = t_end - pulls[0][1]
    spans = {s: prof.mean_ms(s) for s in ("dispatch.plan",
                                          "dispatch.enqueue")}
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    answered = len(lat) * pool.batch
    log(f"window: {len(lat)} batches in {window_s:.3f} s")

    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.time()
    ref = Reference(corpus, cfg["scoring"], cfg["max_query_terms"], device,
                    alive=alive)
    ref_ids, ref_scores = ref.topk([pool.text(q) for q in pool.sample], k)
    checks = compare(answers, pool.sample, ref_ids, ref_scores)
    log(f"reference: {len(pool.sample)} queries in "
        f"{time.time() - t:.3f} s")

    dev_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    device_rec = {
        "platform": "gpu" if cuda else "cpu",
        "kind": dev_name,
        "count": 1,
        "memory_peak_bytes": int(max(peak_setup, peak_window)),
    }
    result = {"correct": passed(checks), "attempted": len(pulls)
              * pool.batch, "failed": len(pulls) * pool.batch - answered}
    if trace:
        tr = None
        if os.path.exists(trace_path):
            log(f"trace: {os.path.getsize(trace_path)} B")
            tr = trace_mod.read(trace_path)
            os.remove(trace_path)
        readings = roofline.card_readings() if cuda else {}
        peaks = roofline.peaks_for(dev_name, readings)
        run = {"spans": spans, "trace": tr, "batches": len(lat),
               "least_s": window_counts(pool, ref, corpus, pulls, k, peaks)
               if peaks else None}
        log(f"card: {readings}")
        metrics = {}
        for m in reg.metrics("per_layer", name):
            v = reg.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        if tr is not None:
            device_rec["busy_s"] = tr["busy_s"]
            device_rec["window_s"] = tr["window_s"]
            result["breakdown"] = {"device_ops": tr["device_ops"],
                                   "idle_gaps": tr["idle_gaps"]}
    else:
        lat_ms = np.array(lat) * 1e3
        values = {
            "setup_s": setup_s,
            "qps": answered / window_s,
            "batch_p95_ms": float(np.percentile(lat_ms, 95)),
            "serve_peak_gib": peak_window / GIB if cuda else None,
        }
        result["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in reg.metrics("end_to_end", name)
            if values.get(m["name"]) is not None
        }
        log(f"latency ms: p50 {np.percentile(lat_ms, 50):.3f} "
            f"max {lat_ms.max():.3f}")
    result["device"] = device_rec
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from .registry import Registry

    reg = Registry()
    chips = int(reg.workload(args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, count: "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(reg, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded modules it may not: {bad}")
        return 3
    for key, c in result["checks"].items():
        log(f"check {key}: {c['value']} (limit {c['rule']} {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
