"""The port's host profile (document_search_engine_tpu_torch/tools/
host_profile.py) on the CPU at a tiny size: positive stage times, the
cProfile's top entries, the device step restored afterwards (also when
the profiled body raises), the dummy step's shape and device, and the
card asked for by default."""
import pytest
import torch

from document_search_engine_tpu_torch.engine import engine as engine_mod
from document_search_engine_tpu_torch.engine.engine import SearchEngine
from document_search_engine_tpu_torch.tools import host_profile as H

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

TINY = {"HP_DOCS": "3000", "HP_VOCAB": "2000", "HP_NQ": "64",
        "HP_ITERS": "2"}


@pytest.mark.parametrize("split", ["", "64"])
def test_stage_times_and_restore(split, capsys):
    real = engine_mod._batch_step
    out = H.main(device="cpu", env=dict(TINY, HP_SPLIT=split))
    assert engine_mod._batch_step is real
    for stage in ("analyze_ms", "dispatch_ms", "collect_ms", "total_ms",
                  "ceiling_qps"):
        assert out[stage] > 0, stage
    # the dispatch spans and the graphs are the card's
    assert out["plan_ms"] is None and out["enqueue_ms"] is None
    assert out["captures"] == 0
    assert 0 < len(out["profile_top"]) <= H.PROFILE_TOP
    assert any("_dispatch" in fn for fn, _s in out["profile_top"])
    printed = capsys.readouterr().out
    assert "ceiling" in printed and "cumulative" in printed


def test_no_profile():
    out = H.main(device="cpu", env=dict(TINY, HP_PROFILE="0"))
    assert out["profile_top"] == []


def test_restored_when_the_body_raises(monkeypatch):
    real = engine_mod._batch_step

    def failing_collect(self, fut):
        assert engine_mod._batch_step is H.fake_step
        raise RuntimeError("collect failed")

    monkeypatch.setattr(SearchEngine, "_collect", failing_collect)
    with pytest.raises(RuntimeError, match="collect failed"):
        H.main(device="cpu", env=TINY)
    assert engine_mod._batch_step is real


def test_fake_step_shape():
    rows = torch.zeros((8, 3), dtype=torch.int32)
    out = H.fake_step([], rows, rows, plan=(), k=7, n_real=5)
    assert out.shape == (5, 14) and out.dtype == torch.int32
    assert out.device == rows.device


def test_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        H.main(env=TINY)


def test_prof_mean_ms():
    from document_search_engine_tpu_torch.utils import prof

    prof.reset()
    for _ in range(3):
        with prof.phase("tools.x"):
            pass
    assert prof.mean_ms("tools.x") >= 0
    assert prof.mean_ms("tools.never") is None
    prof.reset()
    assert prof.mean_ms("tools.x") is None
