"""The port's differential fuzz (document_search_engine_tpu_torch/tools/
fuzz_differential.py) on the CPU: twelve seeds that together draw every
scorer at every shard count, every split value, both kinds, k above 16,
the fused kernel's B1, large-k and doc-limit routes and the rank-only
route pass against the oracle after every step; a seed draws the same
trial as the repo-root tools/fuzz_differential.py (the same description,
from the original run on the JAX CPU backend); a score that differs from
the oracle's fails the trial with its repro line; and the card is asked
for by default."""
import importlib.util
from pathlib import Path

import pytest
import torch

from document_search_engine_tpu_torch.engine.engine import SearchEngine
from document_search_engine_tpu_torch.tools import fuzz_differential as F

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# chosen by their draws (F.trial_config) to cover every scorer x shard
# count, split value and kind, k 37 and 100, and each kernel route
SEEDS = (27, 34, 142, 186, 214, 312, 316, 325, 339, 450, 495, 510)
# the two cheapest on the JAX side: the plain scorer, 1 shard or none
DESC_SEEDS = (312, 495)


def _load_reference_tool():
    sp = importlib.util.spec_from_file_location(
        "dse_fuzz_reference", REPO / "tools" / "fuzz_differential.py")
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def test_seeds_cover_the_draws():
    cfgs = [F.trial_config(s) for s in SEEDS]
    assert {(c["scorer"], c["n_shards"]) for c in cfgs} == {
        (sc, sh) for sc in ("fused", "xla", "xla_rank") for sh in (0, 1, 2, 4)}
    assert {c["split"] for c in cfgs} == {None, 2, 4, 16}
    assert {c["kind"] for c in cfgs} == {"tfidf", "bm25"}
    assert {37, 100} <= {c["k"] for c in cfgs}
    fused = [c for c in cfgs if c["scorer"] == "fused"]
    assert any(c["split"] is None and c["k"] <= 16 for c in fused)  # B1
    assert any(c["split"] is None and c["k"] > 16 for c in fused)  # B2t
    assert any(c["split"] is not None for c in fused)  # dlim


@pytest.mark.parametrize("seed", SEEDS)
def test_trial_passes_on_cpu(seed):
    desc = F.one_trial(seed, device="cpu")
    assert desc == F.describe(seed, F.trial_config(seed))


@pytest.mark.parametrize("seed", DESC_SEEDS)
def test_seed_draws_the_original_trial(seed):
    ref = _load_reference_tool()
    assert F.one_trial(seed, device="cpu") == ref.one_trial(seed)


def test_mismatch_raises_with_repro_line(monkeypatch):
    seed = 312  # a single engine (shards 0)
    assert F.trial_config(seed)["n_shards"] == 0
    search = SearchEngine.search

    def flipped(self, queries, k=10):
        ids, scores = search(self, queries, k)
        scores = scores.copy()
        scores[0, 0] += 1
        return ids, scores

    monkeypatch.setattr(SearchEngine, "search", flipped)
    with pytest.raises(AssertionError) as err:
        F.one_trial(seed, device="cpu")
    msg = str(err.value)
    assert msg.startswith(F.describe(seed, F.trial_config(seed)) + " [build]")
    assert "mismatch rows [0]" in msg and "oracle sc" in msg


def test_run_trials_reports(capsys):
    out = F.main(device="cpu", env={"FUZZ_TRIALS": "2", "FUZZ_SEED": "34"})
    assert out["trials"] == 2 and out["base_seed"] == 34
    assert out["captures"] == 0  # no step graphs on the CPU
    assert not any(out["launches"].values())  # CPU tensors launch nothing
    assert out["configs"] == [F.trial_config(34), F.trial_config(135)]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "differential fuzz: 2 trials, base seed 34"
    assert lines[-1].startswith("ALL 2 TRIALS PASSED")


def test_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        F.one_trial(SEEDS[0])
