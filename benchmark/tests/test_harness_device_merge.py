"""The reader of device_merge_share (the share of the queries over several
segments whose segments the program merged on the card): None on a
registry without its counters, without the new one, or with no query
over several segments; 100.0 and 0.0 on registries filled by hand; and
its entry in BENCHMARK.json, listed for the live cell alone."""
import json

import pytest

from benchmark.registry import ROOT, Registry
from document_search_engine_tpu_torch.utils import prof

NAME, CELL = "device_merge_share", "nq-live-natural-k100"


@pytest.fixture(autouse=True)
def _clean_registry():
    prof.reset()
    yield
    prof.reset()


def _read():
    return Registry().reader(NAME)({})


@pytest.mark.parametrize("counts", [
    {}, {"step.segment_merge_queries": 1024},
    {"step.device_merge_queries": 0, "step.segment_merge_queries": 0}])
def test_none_without_both_counters_or_any_merged_query(counts):
    """The parent program counts neither; a one-segment index counts 0."""
    for name, n in counts.items():
        prof.count(name, n)
    assert _read() is None


def test_a_program_without_counters_reads_nothing(monkeypatch):
    monkeypatch.delattr(prof, "total")
    assert _read() is None


@pytest.mark.parametrize("merged,want", [((1024, 1024, 512), 100.0),
                                         ((0, 0, 0), 0.0)])
def test_readers_on_a_registry_filled_by_hand(merged, want):
    """Three batches over several segments, 2,560 queries in all."""
    for queries, on_card in zip((1024, 1024, 512), merged):
        prof.count("step.segment_merge_queries", queries)
        prof.count("step.device_merge_queries", on_card)
    assert _read() == pytest.approx(want)


def test_its_entry_in_benchmark_json():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    m, = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert (m["layer"], m["moves"], m["workloads"], m["unit"],
            m["better"], m["source"]) == (
        "kernels", "qps", [CELL], "%", "higher", "program_counter")
    assert spec["per_layer"][-1]["name"] == NAME
    reg = Registry()
    assert NAME in {x["name"] for x in reg.metrics("per_layer", CELL)}
    for other in ("msmarco-natural-k10", "nq-natural-k100"):
        assert NAME not in {x["name"]
                            for x in reg.metrics("per_layer", other)}
