"""The port's vectorized oracle (oracle/vector.py) against its dict oracle
and against the JAX package's VectorOracleEngine, through add/delete
steps; and the port's engine against it at the 20-Newsgroups scale of
the reference's parity gate (tests/test_parity.py). Ids and integer
scores must be equal."""
import numpy as np
import pytest
import torch

from document_search_engine_tpu.config import IndexConfig as RefC
from document_search_engine_tpu.config import ScoringConfig as RefS
from document_search_engine_tpu.oracle import VectorOracleEngine as RefVector
from document_search_engine_tpu_torch import (
    IndexConfig,
    ScoringConfig,
    SearchEngine,
)
from document_search_engine_tpu_torch.corpus.synth import (
    synth_corpus,
    synth_queries,
)
from document_search_engine_tpu_torch.oracle import (
    OracleEngine,
    VectorOracleEngine,
)

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)


def _assert_same(got, want, what):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w, what)


@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_vector_oracle_matches_dict_oracle_and_reference(kind):
    """Three steps of delete + add (tests/test_parity.py's history): the
    port's vectorized oracle == its dict oracle == the JAX package's
    vectorized oracle, at k 10 and at k past the corpus."""
    docs = synth_corpus(n_docs=90, vocab_size=800, mean_len=40, seed=9)
    queries = synth_queries(docs, n_queries=17, terms_per_query=5, seed=10)
    queries += ["", "zzznotaword", docs[0].split()[0]]
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    engines = (OracleEngine(cfg), VectorOracleEngine(cfg),
               RefVector(RefC(scoring=RefS(kind=kind))))
    for eng in engines:
        eng.build(docs)
    for step in range(3):
        for k in (10, 120):
            want = engines[0].search(queries, k=k)
            for eng in engines[1:]:
                _assert_same(eng.search(queries, k=k), want,
                             f"{type(eng).__module__} step {step} k {k}")
        for eng in engines:
            eng.delete_docs([step * 7, step * 11 + 1])
            eng.add_docs(docs[step : step + 2])
    with pytest.raises(ValueError):
        engines[1].search(queries, k=0)


@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_engine_matches_vector_oracle_at_scale(kind):
    """The parity gate at a 20-Newsgroups-scale corpus (12,000 docs, as
    tests/test_parity.py runs it): SearchEngine on the CPU == the
    vectorized oracle."""
    docs = synth_corpus(n_docs=12000, vocab_size=9000, mean_len=60, seed=6)
    queries = synth_queries(docs, n_queries=24, terms_per_query=5, seed=7)
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    eng = SearchEngine(cfg, device="cpu")
    eng.build(docs)
    ora = VectorOracleEngine(cfg)
    ora.build(docs)
    got = eng.search(queries, k=10)
    _assert_same(got, ora.search(queries, k=10), kind)
    assert (got[1][:, 0] > 0).all()
