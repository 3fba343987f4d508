"""The plain reference against the port's CPU scorers, and the
correctness check's control and faults on tiny cells."""
import numpy as np
import pytest

from benchmark import control, run
from benchmark.gen.corpus import draw_corpus
from benchmark.gen.queries import Pool
from benchmark.reference.bm25 import Reference
from harness_helpers import tiny_tree

CELLS = ("msmarco-natural-k10", "nq-natural-k100")


def drawn(reg, cell, seed):
    wl = reg.workload(cell)
    cfg = reg.config(wl["config"])
    mix = reg.traffic(wl["traffic"])
    corp = draw_corpus(cfg, seed, "cpu")
    return cfg, mix, corp, Pool(cfg, mix, corp, seed)


@pytest.mark.parametrize("scorer", ("xla", "fused", "xla_rank"))
@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_the_port(tmp_path, cell, scorer):
    reg = tiny_tree(tmp_path)
    cfg, mix, corp, pool = drawn(reg, cell, 21)
    eng = run.make_engine(cfg, "cpu")
    eng.scorer = scorer
    eng.build(corp.texts)
    texts = pool.batches[0] + pool.batches[1]
    ids, scores = eng.search(texts, k=mix["k"])
    ref = Reference(corp, cfg["scoring"], cfg["max_query_terms"], "cpu",
                    block_tokens=4096)
    r_ids, r_scores = ref.topk(texts, mix["k"])
    assert (r_scores[:, 0] > 0).any()
    np.testing.assert_array_equal(r_ids, ids)
    np.testing.assert_array_equal(r_scores, scores)


def test_the_bm25_reference_refuses_another_kind(tmp_path):
    reg = tiny_tree(tmp_path)
    cfg, _mix, corp, _pool = drawn(reg, "msmarco-natural-k10", 3)
    assert reg.reference(cfg["scoring"]["kind"]) is not None
    with pytest.raises(ValueError, match="tfidf"):
        Reference(corp, dict(cfg["scoring"], kind="tfidf"),
                  cfg["max_query_terms"], "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tmp_path, cell):
    reg = tiny_tree(tmp_path)
    result = run.run_cell(reg, cell, 2**31 + 5, 0.5, False, "cpu")
    checks = result["checks"]
    assert result["correct"] and checks["wrong_answers"]["value"] == 0
    assert checks["answers_compared"]["value"] >= 40
    assert list(result)[-1] == "checks"
    want = {m["name"] for m in reg.spec["end_to_end"]
            if cell in m.get("workloads", [cell])} - {"serve_peak_gib"}
    assert set(result["metrics"]) == want


@pytest.mark.parametrize("seed", (1, 2, 3))
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(tmp_path, cell, seed):
    """The reference in bfloat16 in the program's place is not correct."""
    reg = tiny_tree(tmp_path)
    checks = control.control_reading(reg, cell, seed, "cpu")
    assert not run.passed(checks)
    assert checks["wrong_answers"]["value"] >= 10


def altered(fault):
    """SearchEngine.search_stream with its answers broken by `fault`."""
    from document_search_engine_tpu_torch import SearchEngine

    plain = SearchEngine.search_stream

    def broken(self, batches, k=10, depth=2):
        for ids, scores in plain(self, batches, k=k, depth=depth):
            ids, scores = ids.copy(), scores.copy()
            fault(ids, scores)
            yield ids, scores

    return broken


def one_score(ids, scores):
    scores[7, 0] += 1


def one_id(ids, scores):
    ids[3, 0], ids[3, 1] = ids[3, 1], ids[3, 0]


def half_batch(ids, scores):
    # the second half of the batch left out: no answer for it
    n = len(ids) // 2
    ids[n:], scores[n:] = -1, -1


@pytest.mark.parametrize("fault", (one_score, one_id, half_batch))
def test_a_fault_is_caught(tmp_path, monkeypatch, fault):
    from document_search_engine_tpu_torch import SearchEngine

    reg = tiny_tree(tmp_path, sample=48 * 4)
    monkeypatch.setattr(SearchEngine, "search_stream", altered(fault))
    result = run.run_cell(reg, "msmarco-natural-k10", 9, 0.3, False, "cpu")
    assert not result["correct"]
    assert result["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.card
def test_the_control_fails_on_the_card(tmp_path, card):
    reg = tiny_tree(tmp_path, docs={"msmarco-passage-bm25": 200000,
                                    "beir-nq-bm25": 100000})
    for cell in CELLS:
        assert control.control_reading(reg, cell, 1, card)[
            "wrong_answers"]["value"] > 0
