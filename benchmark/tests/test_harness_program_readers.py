"""The readers of the program's serving-path spans and pair counter
(analyze_ms, analyze_wait_ms, collect_ms, kernel_gpairs_s): nothing read
from an empty registry or a program without the counter, the right value
from a registry filled by hand, and a whole traced CPU run through an
engine that keeps step graphs under a stand-in capturer, whose pair count
is the roofline's for the window's batches."""
import json
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import roofline, run, trace
from benchmark.registry import Registry
from document_search_engine_tpu_torch.engine.step_graph import StepGraphs
from document_search_engine_tpu_torch.utils import prof
from harness_helpers import tiny_tree

NEW = ("analyze_ms", "analyze_wait_ms", "collect_ms", "kernel_gpairs_s")
SPAN_OF = {"analyze_ms": "stream.analyze",
           "analyze_wait_ms": "stream.wait_analysis",
           "collect_ms": "collect.assemble"}
# a window's device account: 2 kernel events over 0.5 s of kernel time
TRACE = {"window_s": 1.0, "busy_s": 0.6, "kernel_s": 0.5,
         "kernel_events": 2, "device_ops": [], "idle_gaps": []}


@pytest.fixture(autouse=True)
def _clean_registry():
    prof.reset()
    yield
    prof.reset()


def recorded(tr=TRACE):
    return {"spans": {"dispatch.plan": None, "dispatch.enqueue": None},
            "trace": tr, "batches": 4, "least_s": None}


def test_every_new_metric_has_its_entry_and_reader():
    reg = Registry()
    entries = {m["name"]: m for m in reg.spec["per_layer"]}
    for name in NEW:
        assert "workloads" not in entries[name]
        assert entries[name]["moves"] == "qps"
        assert callable(reg.reader(name))
    # no name twice
    assert len(entries) == len(reg.spec["per_layer"])


@pytest.mark.parametrize("name", NEW)
def test_an_empty_registry_reads_nothing(name):
    assert Registry().reader(name)(recorded()) is None


def test_readers_on_a_registry_filled_by_hand(monkeypatch):
    """Each span twice (3 ms and 5 ms), and 7e8 pairs over 0.5 s of
    kernels."""
    ticks = iter([0.0, 0.003, 1.0, 1.005] * len(SPAN_OF))
    monkeypatch.setattr(prof, "time",
                        SimpleNamespace(perf_counter=lambda: next(ticks)))
    for span in SPAN_OF.values():
        for _ in range(2):
            with prof.phase(span):
                pass
    prof.count("step.pairs", 3e8)
    prof.count("step.pairs", 4e8)
    reg = Registry()
    for name in SPAN_OF:
        assert reg.reader(name)(recorded()) == pytest.approx(4.0)
    assert reg.reader("kernel_gpairs_s")(recorded()) == pytest.approx(1.4)


def test_pairs_without_a_trace_or_a_kernel_read_nothing():
    prof.count("step.pairs", 1000)
    read = Registry().reader("kernel_gpairs_s")
    assert read(recorded(tr=None)) is None
    assert read(recorded(tr=dict(TRACE, kernel_events=0))) is None
    assert read(recorded()) == pytest.approx(1000 / 0.5 / 1e9)


def test_a_program_without_the_counter_reads_nothing(monkeypatch):
    """The parent program's prof has no total(): the reader gives None
    and does not raise."""
    monkeypatch.delattr(prof, "total")
    assert Registry().reader("kernel_gpairs_s")(recorded()) is None


def _fake_capture(step, static_in):
    static_out = step(*static_in)
    return (lambda: static_out.copy_(step(*static_in))), static_out


@pytest.mark.parametrize("cell", ("msmarco-natural-k10", "nq-natural-k100"))
def test_a_traced_run_reads_the_spans(tmp_path, cell, monkeypatch):
    """A traced CPU run of a tiny cell, its engine keeping graphs: the
    span readers read, the trace holds every span, and the window's
    step.pairs equals batch_counts' pairs over the window's batches."""
    reg = tiny_tree(tmp_path)
    make, count = run.make_engine, run.window_counts
    seen, traced = {}, {}

    def engine(cfg, device):
        eng = make(cfg, device)
        eng.scorer = "fused"
        eng._graphs = StepGraphs("cpu", capturer=_fake_capture)
        return eng

    def spy(pool, ref, corpus, pulls, k, peaks):
        cls = ref.cls_of_index[corpus.perm[pool.ranks]]
        pairs = 0
        for j, _t in pulls:
            q0 = j * pool.batch
            terms = [np.unique(cls[pool.ptr[q]:pool.ptr[q + 1]])
                     for q in range(q0, q0 + pool.batch)]
            pairs += roofline.batch_counts(terms, ref.df, k)["ops"]
        seen.update(want=pairs, got=prof.total("step.pairs"),
                    batches=len(pulls))
        return count(pool, ref, corpus, pulls, k, peaks)

    def read_trace(path):
        with open(path) as f:
            traced["names"] = {e["name"] for e in json.load(f)["traceEvents"]
                               if e.get("cat") == "user_annotation"}
        return trace_read(path)

    trace_read = trace.read
    # a trace file of its own: runs of the cell in other workers share
    # the temporary directory and the file's name
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(run, "make_engine", engine)
    monkeypatch.setattr(run, "window_counts", spy)
    monkeypatch.setattr(trace, "read", read_trace)
    monkeypatch.setattr(roofline, "peaks_for", lambda name, r: {
        "hbm_bytes_s": 3.35e12, "int32_ops_s": 1.67e13,
        "sm_clock_mhz": 1980.0})
    result = run.run_cell(reg, cell, 41, 0.2, True, "cpu")
    assert result["correct"]
    metrics = result["metrics"]
    for name in ("analyze_ms", "analyze_wait_ms", "collect_ms", "plan_ms",
                 "enqueue_ms"):
        assert metrics[name]["value"] > 0, name
    # the CPU runs no kernel: no kernel time to divide by
    assert "kernel_gpairs_s" not in metrics
    assert seen["batches"] >= 1 and seen["want"] > 0
    assert seen["got"] == seen["want"]
    assert {"stream.analyze", "stream.wait_analysis", "dispatch.plan",
            "dispatch.enqueue", "collect.wait", "collect.assemble",
            trace.WINDOW} <= traced["names"]
