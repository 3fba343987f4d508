"""The torch port's SearchEngine (CPU) against the frozen oracle and the
JAX SearchEngine on the toy corpora of tests/test_parity.py, through
search and search_stream, in both scorer modes ("plain", the CPU
default, and "fused", whose kernel wrapper takes the plain version on
CPU tensors but keeps the fused path's block family, compacted plans
and r_c buckets), k up to 200 (fused mode takes the plain scorer over
uncompacted plans above 128, as the reference does). Also: a JAX-built
index carried across by index/convert.py serves identically, an
add_docs past the auto-compact bound compacts, and every scorer path
serves. Each package's engine is configured with its own package's
IndexConfig."""
import numpy as np
import pytest
import torch

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.corpus.synth import synth_corpus, synth_queries
from document_search_engine_tpu.engine.engine import (
    SearchEngine as RefEngine,
)
from document_search_engine_tpu.oracle import OracleEngine
from document_search_engine_tpu_torch import SearchEngine
from document_search_engine_tpu_torch import config as port_config
from document_search_engine_tpu_torch.index.convert import (
    DEVICE_FIELDS,
    segment_from_reference,
)

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)


def _toy(seed=0, n_docs=120):
    docs = synth_corpus(n_docs=n_docs, vocab_size=800, mean_len=40, seed=seed)
    queries = synth_queries(docs, n_queries=17, terms_per_query=5,
                            seed=seed + 1)
    queries += ["", "zzznotaword", docs[0].split()[0]]
    return docs, queries


def _port_cfg(cfg):
    """The port's IndexConfig with the same fields as a reference one."""
    return port_config.IndexConfig.from_json(cfg.to_json())


def _port(cfg, mode):
    eng = SearchEngine(_port_cfg(cfg), device="cpu")
    eng.scorer = mode
    return eng


def _assert_same(got, want, what):
    np.testing.assert_array_equal(got[0], want[0], f"{what} ids")
    np.testing.assert_array_equal(got[1], want[1], f"{what} scores")


@pytest.mark.parametrize("mode", ["plain", "fused"])
@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_port_matches_oracle_and_reference(kind, mode):
    docs, queries = _toy()
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    eng = _port(cfg, mode)
    eng.build(docs)
    ora = OracleEngine(cfg)
    ora.build(docs)
    ref = RefEngine(cfg)
    ref.build(docs)
    for k in (1, 10, 16):
        want = ora.search(queries, k=k)
        _assert_same(eng.search(queries, k=k), want, f"{kind} {mode} k={k}")
        _assert_same(ref.search(queries, k=k), want, f"reference k={k}")
    batches = [queries[:4], queries[4:5], [], queries[5:]]
    got = list(eng.search_stream(batches, k=10, depth=2))
    _assert_same(
        (np.concatenate([g[0] for g in got]),
         np.concatenate([g[1] for g in got])),
        ora.search(queries, k=10),
        f"{kind} {mode} stream",
    )


@pytest.mark.parametrize("mode", ["plain", "fused"])
@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_port_incremental_segments_match_oracle(kind, mode):
    """Two segments (add_docs re-materializes every segment against the
    merged stats) and the host merge of per-segment top-k."""
    docs, queries = _toy(seed=4, n_docs=60)
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    eng = _port(cfg, mode)
    ora = OracleEngine(cfg)
    eng.build(docs[:40])
    ora.build(docs[:40])
    _assert_same(eng.search(queries), ora.search(queries), "one segment")
    eng.add_docs(docs[40:])
    ora.add_docs(docs[40:])
    assert len(eng.segments) == 2
    _assert_same(eng.search(queries), ora.search(queries), "two segments")


@pytest.mark.parametrize("mode", ["plain", "fused"])
def test_port_ties_small_corpus_and_slot_overflow(mode):
    for kind in ("tfidf", "bm25"):
        cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
        docs = ["same exact words"] * 5 + ["different thing entirely"]
        eng, ora = _port(cfg, mode), OracleEngine(cfg)
        eng.build(docs)
        ora.build(docs)
        qs = ["same words", "different"]
        _assert_same(eng.search(qs, k=6), ora.search(qs, k=6), "ties")
    docs = ["alpha beta", "beta gamma", "delta epsilon"]
    eng, ora = _port(IndexConfig(), mode), OracleEngine()
    eng.build(docs)
    ora.build(docs)
    _assert_same(eng.search(["beta", "zeta"], k=8),
                 ora.search(["beta", "zeta"], k=8), "k > corpus")
    docs, _ = _toy(seed=9, n_docs=50)
    cfg = IndexConfig(max_query_terms=4)
    eng, ora = _port(cfg, mode), OracleEngine(cfg)
    eng.build(docs)
    ora.build(docs)
    big_q = [" ".join(docs[3].split()[:20])]
    _assert_same(eng.search(big_q), ora.search(big_q), "slot overflow")


@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_reference_index_carried_across_serves_identically(kind):
    """A JAX-built two-segment index, its device arrays handed over as
    numpy copies, serves the same ids and scores from the port."""
    docs, queries = _toy(seed=2, n_docs=80)
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    ref = RefEngine(cfg)
    ref.build(docs[:50])
    ref.add_docs(docs[50:])
    segments = [
        segment_from_reference(
            host, {f: np.asarray(getattr(dev, f)) for f in DEVICE_FIELDS},
            "cpu",
        )
        for host, dev in ref.segments
    ]
    for mode in ("plain", "fused"):
        eng = _port(cfg, mode)
        eng.load_segments(segments)
        assert eng.n_docs_total == len(docs)
        _assert_same(eng.search(queries, k=10), ref.search(queries, k=10),
                     f"{kind} {mode}")


def test_warmup_and_preplan_then_serve():
    docs, queries = _toy(seed=5, n_docs=100)
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    eng = _port(cfg, "fused")
    eng.build(docs)
    eng.preplan([queries[:10], queries[10:]])
    grows = eng.plan_cache.grows
    eng.warmup(nq=64)
    eng.warmup(queries=queries[:3])
    ora = OracleEngine(cfg)
    ora.build(docs)
    _assert_same(eng.search(queries), ora.search(queries), "after warmup")
    assert eng.plan_cache.grows >= grows


def test_add_docs_past_compaction_bound_compacts():
    """The add_docs that passes auto_compact_segments compacts, as the
    reference does: the fifth segment's add leaves one segment that
    serves the oracle's results over all 50 docs."""
    docs, queries = _toy(seed=8, n_docs=50)
    eng = _port(IndexConfig(), "fused")
    eng.build(docs[:10])
    for lo in (10, 20, 30):
        eng.add_docs(docs[lo : lo + 10])
    assert len(eng.segments) == eng.auto_compact_segments == 4
    assert eng.add_docs(docs[40:]) == list(range(40, 50))
    assert len(eng.segments) == 1 and eng.n_docs_total == 50
    assert eng.segments[0][0].doc_base == 0
    ora = OracleEngine()
    ora.build(docs)
    _assert_same(eng.search(queries), ora.search(queries), "compacted")


@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_fused_large_k_matches_oracle(kind):
    """Fused mode at k 17..128 (the kernel's large-k branch; its plain
    version here) and k = 200 (the plain scorer, uncompacted plans)."""
    docs, queries = _toy(seed=11, n_docs=300)
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    eng = _port(cfg, "fused")
    eng.build(docs[:200])
    eng.add_docs(docs[200:])
    ora = OracleEngine(cfg)
    ora.build(docs)
    for k in (17, 64, 128, 200):
        want = ora.search(queries, k=k)
        _assert_same(eng.search(queries, k=k), want, f"{kind} k={k}")
        assert (want[0][:, 16] >= 0).any()
    got = list(eng.search_stream([queries[:9], queries[9:]], k=64))
    _assert_same(
        (np.concatenate([g[0] for g in got]),
         np.concatenate([g[1] for g in got])),
        ora.search(queries, k=64), f"{kind} stream k=64",
    )


def test_every_scorer_path_serves():
    docs, queries = _toy(seed=3, n_docs=30)
    eng = _port(IndexConfig(), "fused")
    eng.build(docs)
    # doc-range splitting and the fused_dv and xla_rank scorers serve
    ora = OracleEngine()
    ora.build(docs)
    for scorer, split in (("fused", 2), ("fused_dv", None),
                          ("xla_rank", None)):
        eng.scorer, eng.split_rows = scorer, split
        _assert_same(eng.search(queries), ora.search(queries),
                     f"{scorer} split_rows={split}")
    eng.split_rows = None
    # fused k > 16 and search_rerank serve
    eng.scorer = "fused"
    _assert_same(eng.search(queries, k=40), ora.search(queries, k=40),
                 "fused k=40")
    ids, ri, lex = eng.search_rerank(queries, k=5, candidates=16)
    assert ids.shape == ri.shape == lex.shape == (len(queries), 5)
    eng.scorer = "plain"
    _assert_same(eng.search(queries, k=40), ora.search(queries, k=40),
                 "plain k=40")
