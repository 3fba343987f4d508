"""The port's batch-size A/B (document_search_engine_tpu_torch/tools/
nq_ab.py) on the CPU at a tiny size: two legs, each pass returning
nq * iters rows; each leg serving through its own plan-layout cache and,
when the engine keeps step graphs (a stand-in capturer here, as the card
does), its own graphs, with no capture inside a timed pass; the engine's
own cache and graphs put back, also when a pass raises; the card asked
for by default."""
import pytest
import torch

from document_search_engine_tpu_torch import bench as B
from document_search_engine_tpu_torch.config import IndexConfig, ScoringConfig
from document_search_engine_tpu_torch.engine.engine import SearchEngine
from document_search_engine_tpu_torch.engine.step_graph import (
    StepGraphs,
    add_launch_counts,
    launch_counts,
)
from document_search_engine_tpu_torch.tools import nq_ab as N

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

TINY = {"AB_DOCS": "3000", "AB_NQS": "16,32", "AB_ITERS": "4",
        "AB_PASSES": "2", "AB_DEPTH": "2"}


@pytest.fixture(scope="module")
def built():
    return B.build_synth_engine(
        3000, 50_000, 60, IndexConfig(scoring=ScoringConfig(kind="bm25")),
        seed=1, device="cpu")


def fake_capture(step, static_in):
    """The CPU's stand-in for a CUDA graph (tests/test_torch_step_graph.py):
    a replay rewrites the static output from the static inputs."""
    static_out = step(*static_in)

    def replay():
        before = launch_counts()
        static_out.copy_(step(*static_in))
        add_launch_counts(tuple(b - a for a, b in
                                zip(launch_counts(), before)))

    return replay, static_out


def spy_streams(monkeypatch):
    """Records the engine's (plan cache, graphs) at each search_stream."""
    seen = []
    stream = SearchEngine.search_stream

    def spying(self, batches, k=10, depth=2):
        seen.append((self.plan_cache, self._graphs))
        yield from stream(self, batches, k=k, depth=depth)

    monkeypatch.setattr(SearchEngine, "search_stream", spying)
    return seen


def test_two_legs_on_the_plain_path(built, monkeypatch):
    eng = built[0]
    own = eng.plan_cache
    seen = spy_streams(monkeypatch)
    out = N.main(device="cpu", env=TINY, built=built)
    assert sorted(out["legs"]) == [16, 32]
    for nq, leg in out["legs"].items():
        iters = max(4 * 16 // nq, 4)
        assert leg["iters"] == iters and len(leg["passes"]) == 2
        for p in leg["passes"]:
            assert p["n_out"] == nq * iters and p["qps"] > 0
            assert p["captures"] is None and p["plan_ms"] is None
        assert leg["best"] >= leg["median"] > 0 and leg["step_qps"] > 0
    # a warm pass and 2 timed passes a leg, in turns, each leg on its
    # own cache; the engine keeps no graphs on the CPU
    caches = [c for c, _g in seen]
    assert len(seen) == 6 and all(g is None for _c, g in seen)
    assert caches[0] is caches[2] is caches[4] and caches[1] is caches[3]
    assert caches[1] is caches[5] and caches[0] is not caches[1]
    assert own not in caches and eng.plan_cache is own


def test_each_leg_keeps_its_own_graphs(built, monkeypatch):
    eng = built[0]
    own = eng._graphs = StepGraphs("cpu", capturer=fake_capture)
    seen = spy_streams(monkeypatch)
    try:
        out = N.main(device="cpu", env=TINY, built=built)
    finally:
        eng._graphs = None
    graphs = [g for _c, g in seen]
    assert graphs[0] is graphs[2] is graphs[4]
    assert graphs[1] is graphs[3] is graphs[5]
    assert graphs[0] is not graphs[1] and own not in graphs
    assert own.captures == 0
    # every leg captured while warming, none inside a timed pass
    assert graphs[0].captures >= 1 and graphs[1].captures >= 1
    for leg in out["legs"].values():
        for p in leg["passes"]:
            assert p["captures"] == 0
            assert p["plan_ms"] > 0 and p["enqueue_ms"] > 0


def test_a_capture_inside_a_timed_pass_fails(built, monkeypatch):
    eng = built[0]
    own = eng._graphs = StepGraphs("cpu", capturer=fake_capture)
    warmed = []
    use = N.use

    def forgetting(eng_, leg):
        use(eng_, leg)
        # from the first timed pass on, the leg's graphs are dropped
        if len(warmed) >= 2:
            leg.graphs.clear()
        warmed.append(leg.nq)

    monkeypatch.setattr(N, "use", forgetting)
    try:
        with pytest.raises(AssertionError, match="captured inside a timed"):
            N.main(device="cpu", env=TINY, built=built)
        assert eng._graphs is own
    finally:
        eng._graphs = None


def test_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        N.main(env=TINY)
