"""The port's segment-count serving curve (document_search_engine_tpu_
torch/tools/segments_bench.py) on the CPU at a tiny size: every count
returns the same results, which equal the oracle's and, at 2 segments,
the JAX package's engine streamed over the same chunks; a count whose
results differ raises; and the card is asked for by default."""
import numpy as np
import pytest
import torch

from document_search_engine_tpu.config import IndexConfig as RefConfig
from document_search_engine_tpu.config import ScoringConfig as RefScoring
from document_search_engine_tpu.engine.engine import (
    SearchEngine as RefEngine,
)
from document_search_engine_tpu_torch.config import (
    IndexConfig,
    ScoringConfig,
)
from document_search_engine_tpu_torch.engine.engine import SearchEngine
from document_search_engine_tpu_torch.oracle import OracleEngine
from document_search_engine_tpu_torch.tools import segments_bench as S

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

TINY = {"SEG_DOCS": "600", "SEG_VOCAB": "400", "SEG_NQ": "64",
        "SEG_ITERS": "2", "SEG_COUNTS": "1,2,4"}


@pytest.fixture(scope="module")
def curve():
    return S.main(device="cpu", env=TINY)


def test_counts_equal_the_oracle(curve):
    assert set(curve["curve"]) == {1, 2, 4}
    assert all(q > 0 for q in curve["curve"].values())
    orc = OracleEngine(IndexConfig(scoring=ScoringConfig(kind="bm25")))
    orc.build(curve["docs"])
    want = orc.search(curve["queries"], k=S.K)
    np.testing.assert_array_equal(curve["ids"], want[0])
    np.testing.assert_array_equal(curve["scores"], want[1])
    assert (curve["ids"][:, 0] >= 0).any()
    for n, r in curve["per_count"].items():
        assert r["graphs"] == 0 and r["launches_per_batch"] == 0, n
        assert r["plan_ms"] is None and r["enqueue_ms"] is None, n
        assert r["peak_bytes"] is None and r["pool_bytes"] is None, n


def test_two_segments_equal_the_jax_engine(curve):
    docs, queries = curve["docs"], curve["queries"]
    ref = RefEngine(RefConfig(scoring=RefScoring(kind="bm25")))
    ref.auto_compact_segments = None
    ref.auto_compact_dead_frac = None
    chunk = -(-len(docs) // 2)
    ref.build_streaming(docs[i : i + chunk]
                        for i in range(0, len(docs), chunk))
    assert len(ref.segments) == 2
    ids, scores = ref.search(queries, k=S.K)
    np.testing.assert_array_equal(curve["ids"], np.asarray(ids))
    np.testing.assert_array_equal(curve["scores"], np.asarray(scores))


def test_diverging_count_raises(monkeypatch):
    search_stream = SearchEngine.search_stream

    def off_at_four(self, batches, k=10, depth=2):
        for ids, sc in search_stream(self, batches, k, depth):
            if len(self.segments) == 4:
                sc = sc.copy()
                sc[0, 0] += 1
            yield ids, sc

    monkeypatch.setattr(SearchEngine, "search_stream", off_at_four)
    with pytest.raises(AssertionError, match="4-segment results diverged"):
        S.main(device="cpu", env=TINY)


def test_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.main(env=TINY)
