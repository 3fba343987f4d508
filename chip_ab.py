#!/usr/bin/env python3
"""Kernel and serving times of several trees of this repository, side by
side, from one invocation on one card.

    python3 chip_ab.py [--out FILE] TREE [TREE ...]   # e.g. old new new old

Runs `python3 chip_smoke.py` in each TREE (a directory holding a checkout
of the repository) in the order given, one after another on the same
card, and prints per tree every kernel's ms, plain ms and launches from
its "kernels" line, the serving q/s of each path, the host's dispatch
ms a batch (phase 4 and the sharded engine at each shard count), the
card's busy share of phase 9's traced pass, the bench's q/s (best,
median, the step alone), phase graphs' readings where the tree has
them, and the card's name and power limit. Two versions are compared only within one such invocation, in
turns (old, new, new, old), so that drift of the card or its host shows
as a difference between the two runs of one tree. With --out the full
results of every run (its main path, rerank path, further paths,
sharded path, reference path, bench, graphs and kernels lines) are
written to FILE as JSON. Fails if a run fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def run_tree(tree: str) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tree, capture_output=True,
        text=True,
    )
    out = {"tree": tree, "rc": proc.returncode,
           "seconds": time.perf_counter() - t0}
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) < 3:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"chip_smoke.py failed in {tree} "
                         f"(rc {proc.returncode})")
    out["card"] = lines[-2]
    for line in lines:
        for tag, key in (("main path: ", "main"), ("rerank path: ", "rerank"),
                         ("further paths: ", "paths"),
                         ("sharded path: ", "sharded"),
                         ("reference path: ", "reference"),
                         ("bench: ", "bench"), ("graphs: ", "graphs")):
            if line.startswith(tag):
                out[key] = json.loads(line[len(tag):])
        if line.startswith('{"kernels"'):
            out["kernels"] = json.loads(line)["kernels"]
    return out


def summary(r: dict) -> dict:
    qps = {"fused": r["main"]["serving_qps"],
           "search_rerank": r["rerank"]["rerank_qps"]}
    for name, p in r["paths"].items():
        qps[name] = p["serving_qps"]
    out = {
        "tree": r["tree"], "card": r["card"], "seconds": r["seconds"],
        "kernel_ms": {k["name"]: k["ms"] for k in r["kernels"]},
        "serving_qps": qps,
        "dispatch_ms": r["main"]["dispatch_ms"],
        "sharded_dispatch_ms": {
            n: sh["dispatch_ms"]
            for n, sh in r["sharded"]["per_shards"].items()},
        "busy_share": r["reference"]["trace"]["busy_share"],
        "bench": {key: r["bench"]["json"][key]
                  for key in ("value", "median", "step_qps")},
    }
    if "graphs" in r:
        g = r["graphs"]
        out["graphs"] = {key: g[key] for key in (
            "dispatch", "pool_bytes", "graphs", "captures")}
    return out


def main(argv) -> int:
    out_file = None
    if argv[:1] == ["--out"] and len(argv) >= 2:
        out_file, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for tree in argv:
        r = run_tree(tree)
        runs.append(r)
        print("run: " + json.dumps(summary(r)), flush=True)
    if out_file is not None:
        os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
        with open(out_file, "w") as f:
            json.dump(runs, f)
    names = [k["name"] for k in runs[0]["kernels"]]
    print("kernel ms per tree, in the order run:")
    for name in names:
        ms = [next(k["ms"] for k in r["kernels"] if k["name"] == name)
              for r in runs]
        print(f"  {name}: " + " / ".join(f"{m:.3f}" for m in ms))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
