"""The live NQ deployment (`beir-nq-bm25-live`) and its cell
(`nq-live-natural-k100`): the configuration loads, is NQ's collection,
queries and scoring, and names the segments set-up; its entries in
BENCHMARK.json; the readers of its two metrics, segment_merge_ms and
dead_pair_share, on a registry filled by hand and on an empty one; the
cell's own set-up at a test's size (10 segments, 20% deleted, the policy
at 10 and 0.33, k 100), whose port equals the masked reference; and a
traced CPU run of the cell whose line carries both metrics."""
import json
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest

import harness_helpers
from benchmark import roofline, run
from benchmark.gen.corpus import draw_corpus
from benchmark.gen.queries import Pool
from benchmark.reference.bm25 import Reference
from benchmark.registry import ROOT, Registry, setup_of
from document_search_engine_tpu_torch.engine.step_graph import StepGraphs
from document_search_engine_tpu_torch.utils import prof
from harness_helpers import tiny_tree

CONFIG, CELL, BASE = "beir-nq-bm25-live", "nq-live-natural-k100", \
    "beir-nq-bm25"
NEW = ("segment_merge_ms", "dead_pair_share")

# tiny_tree cuts every configuration of BENCHMARK.json to a test's size
# by name; the live configuration takes NQ's. pytest imports every test
# module before it runs a test, so the trees of the other modules see it
harness_helpers.DOCS.setdefault(CONFIG, harness_helpers.DOCS[BASE])


@pytest.fixture(autouse=True)
def _clean_registry():
    prof.reset()
    yield
    prof.reset()


def test_the_configuration_loads_and_names_a_set_up():
    reg = Registry()
    cfg, base = reg.config(CONFIG), reg.config(BASE)
    assert cfg["name"] == CONFIG and cfg["reduced"] == []
    for key in ("corpus", "queries", "vocabulary", "scoring",
                "max_query_terms"):
        assert cfg[key] == base[key], key
    assert cfg["guarantees"].startswith(base["guarantees"])
    setup = setup_of(cfg)
    assert setup == {"name": "segments", "segments": 10,
                     "deleted_share": 0.2, "auto_compact_segments": 10,
                     "auto_compact_dead_frac": 0.33}
    assert callable(reg.setup(setup["name"]))
    assert callable(reg.alive(setup["name"]))
    assert callable(reg.reference(cfg["scoring"]["kind"]))
    for key in ("deleted_share", "segments", "deletions", "dead_fraction",
                "df", "merges"):
        assert cfg["assumed"][key], key


def test_its_entries_in_benchmark_json():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry, = [c for c in spec["configs"] if c["name"] == CONFIG]
    assert entry["reduced"] == [] and len(entry["source"]) <= 200
    assert entry["file"] == f"benchmark/configs/{CONFIG}.json"
    cell, = [w for w in spec["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "natural-k100", 1)
    assert len(cell["why"]) <= 200
    metrics = {m["name"]: m for m in spec["per_layer"]}
    assert (metrics["segment_merge_ms"]["layer"],
            metrics["dead_pair_share"]["layer"]) == ("collect", "kernels")
    for name in NEW:
        m = metrics[name]
        assert m["workloads"] == [CELL] and m["moves"] == "qps", name
    reg = Registry()
    listed = {m["name"] for m in reg.metrics("per_layer", CELL)}
    assert set(NEW) <= listed
    for other in ("msmarco-natural-k10", "nq-natural-k100"):
        assert not set(NEW) & {m["name"]
                               for m in reg.metrics("per_layer", other)}


@pytest.mark.parametrize("name", NEW)
def test_an_empty_registry_reads_nothing(name):
    assert Registry().reader(name)({}) is None


@pytest.mark.parametrize("counts", [{"step.pairs": 10},
                                    {"step.dead_pairs": 5},
                                    {"step.pairs": 0, "step.dead_pairs": 0}])
def test_dead_pair_share_without_both_counters(counts):
    """The parent program counts step.pairs but no step.dead_pairs."""
    for name, n in counts.items():
        prof.count(name, n)
    assert Registry().reader("dead_pair_share")({}) is None


def test_a_program_without_counters_reads_nothing(monkeypatch):
    monkeypatch.delattr(prof, "total")
    assert Registry().reader("dead_pair_share")({}) is None


def test_readers_on_a_registry_filled_by_hand(monkeypatch):
    """The merge span twice (2 ms and 6 ms); 1,000 and 600 pairs of which
    200 and 120 on tombstones."""
    ticks = iter([0.0, 0.002, 1.0, 1.006])
    monkeypatch.setattr(prof, "time",
                        SimpleNamespace(perf_counter=lambda: next(ticks)))
    for _ in range(2):
        with prof.phase("collect.merge_segments"):
            pass
    for pairs, dead in ((1000, 200), (600, 120)):
        prof.count("step.pairs", pairs)
        prof.count("step.dead_pairs", dead)
    reg = Registry()
    assert reg.reader("segment_merge_ms")({}) == pytest.approx(4.0)
    assert reg.reader("dead_pair_share")({}) == pytest.approx(20.0)


def test_the_cells_set_up_at_a_tests_size(tmp_path):
    """The cell's own configuration on a tiny corpus: 10 segments held
    (the policy at 10 segments and 0.33 dead does not fire), a fifth of
    the documents dead, and the port's top 100 equal to the reference's
    over the live documents."""
    reg = tiny_tree(tmp_path)
    wl = reg.workload(CELL)
    cfg, mix = reg.config(wl["config"]), reg.traffic(wl["traffic"])
    assert mix["k"] == 100
    corp = draw_corpus(cfg, 23, "cpu")
    pool = Pool(cfg, mix, corp, 23)
    eng = run.make_engine(cfg, "cpu")
    eng.scorer = "fused"
    alive = reg.setup(setup_of(cfg)["name"])(eng, corp.texts, cfg, 23)
    assert len(eng.segments) == 10
    assert (~alive).sum() == round(0.2 * corp.n_docs)
    texts = pool.batches[0] + pool.batches[1]
    ids, scores = eng.search(texts, k=mix["k"])
    ref = Reference(corp, cfg["scoring"], cfg["max_query_terms"], "cpu",
                    alive=alive, block_tokens=4096)
    r_ids, r_scores = ref.topk(texts, mix["k"])
    assert (r_scores[:, 0] > 0).any()
    np.testing.assert_array_equal(r_ids, ids)
    np.testing.assert_array_equal(r_scores, scores)
    assert not np.isin(ids[ids >= 0], np.flatnonzero(~alive)).any()


def _fake_capture(step, static_in):
    static_out = step(*static_in)
    return (lambda: static_out.copy_(step(*static_in))), static_out


def test_a_traced_run_of_the_cell_reads_both_metrics(tmp_path, monkeypatch,
                                                     capsys):
    """A traced CPU run of the tiny cell, its engine keeping graphs: the
    line is correct, holds 10 segments, and carries segment_merge_ms,
    within collect_ms, and dead_pair_share near the deleted share."""
    reg = tiny_tree(tmp_path)
    make = run.make_engine

    def engine(cfg, device):
        eng = make(cfg, device)
        eng.scorer = "fused"
        eng._graphs = StepGraphs("cpu", capturer=_fake_capture)
        return eng

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(run, "make_engine", engine)
    monkeypatch.setattr(roofline, "peaks_for", lambda name, r: {
        "hbm_bytes_s": 3.35e12, "int32_ops_s": 1.67e13,
        "sm_clock_mhz": 1980.0})
    result = run.run_cell(reg, CELL, 2**31 + 43, 0.2, True, "cpu")
    assert result["correct"]
    assert result["checks"]["wrong_answers"]["value"] == 0
    assert "built: 10 segments held, 500 of 2500 docs dead" in \
        capsys.readouterr().err
    metrics = result["metrics"]
    merge = metrics["segment_merge_ms"]["value"]
    assert 0 < merge <= metrics["collect_ms"]["value"]
    assert 10.0 < metrics["dead_pair_share"]["value"] < 30.0
