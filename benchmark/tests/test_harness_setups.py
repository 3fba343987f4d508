"""Set-up modules: found by name; a configuration without `setup` builds
exactly as before; the live index (setups/segments.py) streams segments
and deletes documents; the plain reference over the live documents
against the port's CPU scorers and against itself over the live subset;
a live run is correct and its control, the reference given no mask, is
not."""
import numpy as np
import pytest

from benchmark import control, run
from benchmark.gen.corpus import Corpus, draw_corpus
from benchmark.gen.queries import Pool
from benchmark.reference.bm25 import Reference
from benchmark.registry import setup_of
from harness_helpers import live, tiny_tree, with_setup

CELLS = ("msmarco-natural-k10", "nq-natural-k100")
CONFIG = {"msmarco-natural-k10": "msmarco-passage-bm25",
          "nq-natural-k100": "beir-nq-bm25"}


def drawn(reg, cell, seed):
    wl = reg.workload(cell)
    cfg = reg.config(wl["config"])
    mix = reg.traffic(wl["traffic"])
    corp = draw_corpus(cfg, seed, "cpu")
    return cfg, mix, corp, Pool(cfg, mix, corp, seed)


def reference(corp, cfg, alive=None):
    return Reference(corp, cfg["scoring"], cfg["max_query_terms"], "cpu",
                     alive=alive, block_tokens=4096)


def live_engine(reg, cell, seed, scorer, **setup):
    """The cell's tiny corpus set up as a live index: (cfg, mix, corpus,
    pool, engine, alive)."""
    reg = with_setup(reg, CONFIG[cell], **live(**setup))
    cfg, mix, corp, pool = drawn(reg, cell, seed)
    eng = run.make_engine(cfg, "cpu")
    eng.scorer = scorer
    alive = reg.setup("segments")(eng, corp.texts, cfg, seed)
    return cfg, mix, corp, pool, eng, alive


def test_setups_are_found_by_name(tmp_path):
    """A configuration's `setup` name names a module that a later change
    adds as a new file; without the key the set-up is single.py."""
    reg = tiny_tree(tmp_path)
    assert reg.setup("single").__name__ == "build"
    assert reg.setup("segments").__name__ == "build"
    assert reg.alive("single")({}, 5, 1) is None
    (tmp_path / "setups" / "replicas-2.py").write_text(
        "from ..gen.corpus import seed_int\n\n\n"
        "def alive(cfg, n_docs, seed):\n    return None\n\n\n"
        "def build(eng, texts, cfg, seed):\n    return seed_int(seed)\n")
    # its relative import resolves to the benchmark's generators
    assert reg.setup("replicas-2")(None, [], {}, -7) == 7
    with pytest.raises(KeyError):
        reg.setup("sharded")
    assert setup_of(reg.config("beir-nq-bm25")) == {"name": "single"}


def test_a_config_without_setup_only_builds(tmp_path, monkeypatch):
    """run_cell with no `setup` key calls the engine's build once on the
    drawn texts and nothing else before it reads the resident bytes."""
    reg = tiny_tree(tmp_path)
    cfg = reg.config("msmarco-passage-bm25")
    texts = draw_corpus(cfg, 13, "cpu").texts
    calls = []
    make = run.make_engine

    class Spy:
        def __init__(self, eng):
            object.__setattr__(self, "eng", eng)

        def __getattr__(self, name):
            value = getattr(self.eng, name)
            if not callable(value):
                calls.append(("get", name))
                return value

            def call(*a, **kw):
                calls.append((name, a, kw))
                return value(*a, **kw)
            return call

        def __setattr__(self, name, value):
            calls.append(("set", name))
            setattr(self.eng, name, value)

    monkeypatch.setattr(run, "make_engine",
                        lambda cfg, device: Spy(make(cfg, device)))
    result = run.run_cell(reg, "msmarco-natural-k10", 13, 0.2, False, "cpu")
    assert result["correct"]
    first = [c[0] for c in calls].index("resident_bytes")
    assert [c[0] for c in calls[:first]] == ["build"]
    (name, args, kw), = calls[:first]
    assert args == (texts,) and kw == {}


@pytest.mark.parametrize("share", (0.0, 0.1, 0.4))
@pytest.mark.parametrize("segments", (1, 3, 8))
def test_the_live_index_set_up(tmp_path, segments, share):
    """S segments held with auto-compaction off; the dead documents are
    the share drawn from the seed, and `alive` draws the same mask
    without an engine."""
    reg = tiny_tree(tmp_path)
    cfg, mix, corp, pool, eng, alive = live_engine(
        reg, "msmarco-natural-k10", 2**31 + 9, "fused",
        segments=segments, deleted_share=share)
    n = corp.n_docs
    assert len(eng.segments) == segments
    assert alive.shape == (n,) and (~alive).sum() == round(share * n)
    alive_of = reg.alive("segments")
    assert np.array_equal(alive_of(cfg, n, 2**31 + 9), alive)
    if share:
        assert not np.array_equal(alive_of(cfg, n, 4), alive)


def test_the_policy_compacts_when_it_is_on(tmp_path):
    """8 segments past auto_compact_segments 4 end as one; the ids stay
    the drawn ones."""
    reg = tiny_tree(tmp_path)
    cfg, mix, corp, pool, eng, alive = live_engine(
        reg, "nq-natural-k100", 3, "fused", segments=8,
        auto_compact_segments=4, auto_compact_dead_frac=0.5)
    assert len(eng.segments) == 1 and not alive.all()
    texts = pool.batches[0]
    ids, scores = eng.search(texts, k=mix["k"])
    r_ids, r_scores = reference(corp, cfg, alive).topk(texts, mix["k"])
    np.testing.assert_array_equal(r_ids, ids)
    np.testing.assert_array_equal(r_scores, scores)


@pytest.mark.parametrize("share", (0.0, 0.1, 0.4))
@pytest.mark.parametrize("segments", (1, 3, 8))
@pytest.mark.parametrize("scorer", ("xla", "fused", "xla_rank"))
@pytest.mark.parametrize("cell", CELLS)
def test_the_masked_reference_equals_the_port(tmp_path, cell, scorer,
                                              segments, share):
    reg = tiny_tree(tmp_path)
    cfg, mix, corp, pool, eng, alive = live_engine(
        reg, cell, 23, scorer, segments=segments, deleted_share=share)
    texts = pool.batches[0] + pool.batches[1]
    ids, scores = eng.search(texts, k=mix["k"])
    r_ids, r_scores = reference(corp, cfg, alive).topk(texts, mix["k"])
    assert (r_scores[:, 0] > 0).any()
    np.testing.assert_array_equal(r_ids, ids)
    np.testing.assert_array_equal(r_scores, scores)
    assert not np.isin(r_ids[r_ids >= 0], np.flatnonzero(~alive)).any()


@pytest.mark.parametrize("scorer", ("xla", "fused", "xla_rank"))
@pytest.mark.parametrize("cell", CELLS)
def test_deleted_twice_and_a_segment_all_deleted(tmp_path, cell, scorer):
    """A second delete_docs call names documents already dead, one of
    them twice, and every document of the second of 3 segments: the
    port's df falls once a document, and the reference with the mask
    that follows still equals it."""
    reg = tiny_tree(tmp_path)
    cfg, mix, corp, pool, eng, alive = live_engine(reg, cell, 29, scorer)
    n = corp.n_docs
    dead = np.flatnonzero(~alive)
    second = np.arange(n // 3, 2 * n // 3)
    eng.delete_docs(np.concatenate([dead[:5], dead[:1], second]))
    alive = alive.copy()
    alive[second] = False
    assert len(eng.segments) == 3
    texts = pool.batches[0] + pool.batches[1]
    ids, scores = eng.search(texts, k=mix["k"])
    r_ids, r_scores = reference(corp, cfg, alive).topk(texts, mix["k"])
    np.testing.assert_array_equal(r_ids, ids)
    np.testing.assert_array_equal(r_scores, scores)
    assert not np.isin(ids, second).any()


def live_subset(corp, alive) -> Corpus:
    """The corpus of the live documents alone, renumbered from 0."""
    keep = np.repeat(alive, corp.lens)
    return Corpus(texts=None, ranks=corp.ranks[keep], lens=corp.lens[alive],
                  perm=corp.perm, vocab=corp.vocab, width=corp.width)


@pytest.mark.parametrize("share", (0.0, 0.1, 0.4))
@pytest.mark.parametrize("cell", CELLS)
def test_the_masked_reference_is_the_reference_of_the_live_docs(
        tmp_path, cell, share):
    reg = with_setup(tiny_tree(tmp_path), CONFIG[cell],
                     **live(deleted_share=share))
    cfg, mix, corp, pool = drawn(reg, cell, 31)
    alive = reg.alive("segments")(cfg, corp.n_docs, 31)
    texts = pool.batches[0] + pool.batches[1]
    masked = reference(corp, cfg, alive)
    ids, scores = masked.topk(texts, mix["k"])
    sub = reference(live_subset(corp, alive), cfg)
    s_ids, s_scores = sub.topk(texts, mix["k"])
    gid = np.flatnonzero(alive)
    np.testing.assert_array_equal(ids, np.where(s_ids >= 0,
                                                gid[s_ids], -1))
    np.testing.assert_array_equal(scores, s_scores)
    np.testing.assert_array_equal(masked.df, sub.df)


@pytest.mark.parametrize("cell", CELLS)
def test_no_mask_is_every_document_live(tmp_path, cell):
    reg = tiny_tree(tmp_path)
    cfg, mix, corp, pool = drawn(reg, cell, 37)
    texts = pool.batches[0] + pool.batches[1]
    plain = reference(corp, cfg)
    full = reference(corp, cfg, np.ones(corp.n_docs, bool))
    for a, b in zip(plain.topk(texts, mix["k"]), full.topk(texts, mix["k"])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(plain.df, full.df)
    with pytest.raises(ValueError, match="shape"):
        reference(corp, cfg, np.ones(corp.n_docs - 1, bool))


@pytest.mark.parametrize("cell", CELLS)
def test_a_live_run_is_correct_and_its_control_is_not(tmp_path, cell,
                                                      monkeypatch):
    """A tiny live run reads correct; the same run with the reference
    given no mask reads wrong answers; and control.py's bfloat16
    reference over the live documents is not correct either."""
    reg = with_setup(tiny_tree(tmp_path), CONFIG[cell],
                     **live(segments=8, deleted_share=0.1))
    result = run.run_cell(reg, cell, 2**31 + 11, 0.5, False, "cpu")
    assert result["correct"]
    assert result["checks"]["wrong_answers"]["value"] == 0
    assert result["checks"]["answers_compared"]["value"] >= 10

    build = reg.setup("segments")

    def unmasked(name):
        assert name == "segments"

        def no_mask(*args):
            build(*args)
            return None
        return no_mask

    monkeypatch.setattr(reg, "setup", unmasked)
    result = run.run_cell(reg, cell, 2**31 + 11, 0.5, False, "cpu")
    assert not result["correct"]
    assert result["checks"]["wrong_answers"]["value"] > 0
    monkeypatch.undo()
    checks = control.control_reading(reg, cell, 2**31 + 11, "cpu")
    assert checks["wrong_answers"]["value"] > 0
