"""The harness's layout: pieces found by name, BENCHMARK.json's shape,
and what the benchmark may import."""
import ast
import json
from pathlib import Path

import pytest

from benchmark.reference import spec
from benchmark.registry import HERE, ROOT, Registry
from harness_helpers import tiny_tree

FORBIDDEN = {"jax", "jaxlib", "flax", "document_search_engine_tpu"}


def imports(path: Path) -> set:
    """Top-level names a module imports (relative imports excluded)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "document_search_engine_tpu_torch" not in imports(path), path


def test_the_harness_uses_the_public_api_only():
    for path in HERE.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        src = path.read_text()
        for bad in ("eng._", ".segments =", "index.builder", "bench.py"):
            assert bad not in src, (path, bad)


def test_new_pieces_are_found_by_name(tmp_path):
    reg = tiny_tree(tmp_path)
    spec = reg.spec
    (tmp_path / "configs" / "extra.json").write_text(json.dumps(
        {"name": "extra", "corpus": {"docs": 7}}))
    (tmp_path / "traffic" / "burst.json").write_text(json.dumps(
        {"terms": "corpus_frequency", "batch": 3}))
    (tmp_path / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return run['x'] * 2\n")
    spec["configs"].append({"name": "extra", "file": "configs/extra.json"})
    spec["workloads"].append({"name": "extra.burst", "config": "extra",
                              "traffic": "burst", "chips": 1})
    spec["per_layer"].append({"name": "new_metric",
                              "workloads": ["extra.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    reg = Registry(tmp_path / "BENCHMARK.json", base=tmp_path,
                   root=tmp_path)
    wl = reg.workload("extra.burst")
    assert reg.config(wl["config"])["corpus"]["docs"] == 7
    assert reg.traffic(wl["traffic"])["batch"] == 3
    assert reg.reader("new_metric")({"x": 4}) == 8
    names = [m["name"] for m in reg.metrics("per_layer", "extra.burst")]
    # a per-layer metric without a workloads key is read in every cell
    # that reports what it moves, a later one too
    assert "new_metric" in names and "plan_ms" in names
    assert "new_metric" not in [
        m["name"] for m in reg.metrics("per_layer", "msmarco-natural-k10")]
    with pytest.raises(KeyError):
        reg.workload("nothing")


def test_loops_and_references_are_found_by_name(tmp_path):
    """A mix's `loop` and a configuration's scoring `kind` name modules
    that a later change adds as new files."""
    reg = tiny_tree(tmp_path)
    assert reg.loop("closed").__name__ == "serve"
    assert reg.reference("bm25").__name__ == "Reference"
    (tmp_path / "loops" / "open-rate.py").write_text(
        "def serve(*a, **kw):\n    return 'open'\n")
    (tmp_path / "reference" / "tfidf.py").write_text(
        "from . import spec\n\n\nclass Reference:\n"
        "    clip = staticmethod(spec.clip_max)\n")
    assert reg.loop("open-rate")() == "open"
    # its relative import resolves to the benchmark's frozen spec
    assert reg.reference("tfidf").clip(32) == spec.clip_max(32)
    for find, name in ((reg.loop, "poisson"), (reg.reference, "dense")):
        with pytest.raises(KeyError):
            find(name)


def test_each_cell_reports_its_metrics():
    """setup_s, another end-to-end metric, and per-layer metrics that
    move an end-to-end metric the cell reports."""
    reg = Registry()
    for w in reg.spec["workloads"]:
        e2e = {m["name"] for m in reg.metrics("end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 3
        layer = reg.metrics("per_layer", w["name"])
        assert layer and all(m["moves"] in e2e for m in layer)
    for m in reg.spec["per_layer"]:
        assert any(m in reg.metrics("per_layer", w["name"])
                   for w in reg.spec["workloads"])


def test_benchmark_json_names_its_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    reg = Registry()
    for c in spec["configs"]:
        cfg = reg.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith(spec["paths"][0] + "/")
    for w in spec["workloads"]:
        assert reg.traffic(w["traffic"])["k"] >= 1
    for m in spec["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
