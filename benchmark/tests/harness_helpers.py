"""Tiny cells for the CPU tests: a temporary benchmark tree whose
configurations are the real ones with fewer documents and whose mixes
are the real ones with small batches, and a live index's set-up laid
over one of them."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.registry import HERE, ROOT, Registry

DOCS = {"msmarco-passage-bm25": 4000, "beir-nq-bm25": 2500}


def tiny_tree(tmp: Path, docs=None, batch=48, pool_batches=4,
              sample=40) -> Registry:
    """A copy of the benchmark's tree under tmp with the documents cut to
    `docs` and the mixes to `pool_batches` batches of `batch` queries."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic"):
        (tmp / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "loops", "reference", "setups"):
        shutil.copytree(HERE / sub, tmp / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["corpus"]["docs"] = (docs or DOCS)[c["name"]]
        c["file"] = f"configs/{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        t = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                       .read_text())
        t.update(batch=batch, pool_batches=pool_batches, sample=sample)
        (tmp / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return Registry(tmp / "BENCHMARK.json", base=tmp, root=tmp)


def with_setup(reg: Registry, config: str, **setup) -> Registry:
    """The tiny tree of `reg` with configuration `config` set up by
    `setup` (its "name" and parameters)."""
    tmp = reg.base
    entry = reg._named(reg.spec["configs"], config, "config")
    cfg = reg.config(config)
    cfg["setup"] = setup
    (tmp / entry["file"]).write_text(json.dumps(cfg))
    return Registry(tmp / "BENCHMARK.json", base=tmp, root=tmp)


def live(**over) -> dict:
    """A segments set-up with the lifecycle policy off."""
    return dict({"name": "segments", "segments": 3, "deleted_share": 0.1,
                 "auto_compact_segments": None,
                 "auto_compact_dead_frac": None}, **over)
