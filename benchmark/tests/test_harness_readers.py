"""The trace reader and each per-layer metric's reader on a recorded
fixture, and the roofline's counts."""
import json
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import roofline, run, trace
from benchmark.registry import Registry
from document_search_engine_tpu_torch.utils import prof
from harness_helpers import tiny_tree

# A window of 1,000 us with two kernels, a copy and a set; the host runs
# a copy op over the first gap and nothing over the second.
FIXTURE = {"traceEvents": [
    {"ph": "X", "cat": "user_annotation", "name": "bench.window",
     "ts": 1000, "dur": 1000},
    {"ph": "X", "cat": "kernel", "name": "fused_search_kernel",
     "ts": 900, "dur": 300},                        # 200 us inside
    {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 1150,
     "dur": 100},                                   # overlaps the first
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1400,
     "dur": 100},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 1700,
     "dur": 50},
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1290,
     "dur": 100},
    {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 1250,
     "dur": 200},
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1500},
]}


# the program's registry over the same window: three spans of one batch
# each, and 300,000 (query, posting) pairs of which the tiled kernels
# scored 240,000
SPANS = {"stream.analyze": 2e-3, "stream.wait_analysis": 0.5e-3,
         "collect.assemble": 1.5e-3}
PAIRS, TILED_PAIRS = 300_000, 240_000


@pytest.fixture
def program(monkeypatch):
    """The program's registry (utils/prof.py) filled with SPANS and the
    pair counters, by a clock that ticks each span's length."""
    prof.reset()
    ticks = iter([t for dt in SPANS.values() for t in (1.0, 1.0 + dt)])
    monkeypatch.setattr(prof, "time",
                        SimpleNamespace(perf_counter=lambda: next(ticks)))
    for span in SPANS:
        with prof.phase(span):
            pass
    prof.count("step.pairs", PAIRS)
    prof.count("step.tiled_pairs", TILED_PAIRS)
    yield
    prof.reset()


def read_fixture(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(FIXTURE))
    return trace.read(str(path))


def test_trace_read(tmp_path):
    tr = read_fixture(tmp_path)
    assert tr["window_s"] == pytest.approx(1000e-6)
    # busy: [1000, 1250) + [1400, 1500) + [1700, 1750)
    assert tr["busy_s"] == pytest.approx(400e-6)
    assert tr["kernel_s"] == pytest.approx(300e-6)
    assert tr["kernel_events"] == 2
    assert tr["device_ops"][0] == ["fused_search_kernel",
                                   pytest.approx(200e-6)]
    gaps = dict(tr["idle_gaps"])
    # [1250, 1400): the innermost op over its middle is aten::copy_
    assert gaps["aten::copy_"] == pytest.approx(150e-6)
    # [1500, 1700) and [1750, 2000): no host op
    assert gaps[trace.HOST_OUTSIDE_TORCH] == pytest.approx(450e-6)


def test_readers_on_the_fixture(tmp_path, program):
    reg = Registry()
    tr = read_fixture(tmp_path)
    recorded = {"spans": {"dispatch.plan": 3.5, "dispatch.enqueue": 1.25},
                "trace": tr, "batches": 4, "least_s": 30e-6}
    want = {"plan_ms": 3.5, "enqueue_ms": 1.25, "kernel_ms": 0.075,
            "kernel_roofline": 10.0, "device_idle_pct": 60.0,
            "analyze_ms": 2.0, "analyze_wait_ms": 0.5, "collect_ms": 1.5,
            # 300,000 pairs over the fixture's 300 us of kernels
            "kernel_gpairs_s": 1.0, "tiled_pair_share": 80.0}
    entries = {m["name"] for m in reg.spec["per_layer"]}
    for name, value in want.items():
        assert name in entries, name
        assert reg.reader(name)(recorded) == pytest.approx(value), name


def test_readers_find_nothing(tmp_path):
    prof.reset()
    reg = Registry()
    empty = {"spans": {"dispatch.plan": None, "dispatch.enqueue": None},
             "trace": None, "batches": 4, "least_s": None}
    for m in reg.spec["per_layer"]:
        assert reg.reader(m["name"])(empty) is None


def test_batch_counts():
    df = np.array([5, 0, 7, 100, 3])
    terms = [np.array([0, 2]), np.array([2, 3]), np.array([4])]
    c = roofline.batch_counts(terms, df, k=10)
    assert c["ops"] == 5 + 7 + 7 + 100 + 3
    assert c["bytes"] == (5 + 7 + 100 + 3) * 8 + 5 * 8 + 3 * 10 * 8
    peaks = roofline.peaks_for("NVIDIA H100 80GB HBM3",
                               {"sm_clock_mhz": "1980"})
    assert peaks["int32_ops_s"] == pytest.approx(132 * 64 * 1.98e9)
    assert roofline.least_seconds(c, peaks) == pytest.approx(
        c["bytes"] / 3.35e12)
    assert roofline.peaks_for("some other card", {}) is None


@pytest.mark.parametrize("cell", ("msmarco-natural-k10", "nq-natural-k100"))
def test_roofline_count_is_the_scorers_same(tmp_path, cell, monkeypatch):
    """The count reads the batch's inputs only: runs on the fused and the
    xla_rank scorer count the same least time for the same batches."""
    reg = tiny_tree(tmp_path)
    counted, used = {}, {}
    make, count = run.make_engine, run.window_counts

    def engine(cfg, device):
        eng = make(cfg, device)
        eng.scorer = mode
        used[mode] = eng
        return eng

    def spy(pool, ref, corpus, pulls, k, peaks):
        counted[mode] = [count(pool, ref, corpus, [(j, 0.0)], k, peaks)
                         for j in range(pool.n_batches)]
        return count(pool, ref, corpus, pulls, k, peaks)

    monkeypatch.setattr(run, "make_engine", engine)
    monkeypatch.setattr(run, "window_counts", spy)
    monkeypatch.setattr(roofline, "peaks_for", lambda name, r: {
        "hbm_bytes_s": 3.35e12, "int32_ops_s": 1.67e13,
        "sm_clock_mhz": 1980.0})
    for mode in ("fused", "xla_rank"):
        result = run.run_cell(reg, cell, 31, 0.2, True, "cpu")
        assert result["correct"] and used[mode].scorer_mode == mode
    assert counted["fused"] == counted["xla_rank"]
    assert min(counted["fused"]) > 0
