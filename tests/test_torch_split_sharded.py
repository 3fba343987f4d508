"""Doc-range splitting in the torch port's sharded engine (CPU meshes):
the piece structure is shared by every shard, while each shard's record
ranges and doc limits come from its OWN resident quantile table, so
each (shard, piece) covers a disjoint local doc range and the gather
merge over shards plus the host merge over pieces equals the unsplit
ranking bit for bit. The quantile tables equal the JAX package's
`_sharded_quantiles` and the host yardstick; results equal the oracle,
the unsplit engine and the single engine at 1, 2 and 4 shards, with
mixed thresholds through a preplan-seeded search_stream, and through
add and delete. The JAX package's MERGE_FLIP lever (a Pallas merge
scheme, tests/test_split_sharded.py) has no counterpart in the port,
whose merge is csrc/rank.cuh's, so it is left out here."""
import numpy as np
import pytest
import torch

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.corpus.synth import synth_corpus, synth_queries
from document_search_engine_tpu.parallel.dist import (
    DistributedSearchEngine as RefDist,
)
from document_search_engine_tpu.parallel.mesh import make_mesh as ref_mesh
from document_search_engine_tpu_torch import (
    DistributedSearchEngine,
    SearchEngine,
    make_mesh,
)
from document_search_engine_tpu_torch import config as port_config
from document_search_engine_tpu_torch.index import builder as B
from document_search_engine_tpu_torch.oracle import OracleEngine

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus():
    docs = synth_corpus(n_docs=120, vocab_size=400, mean_len=40, seed=61)
    queries = synth_queries(docs, n_queries=10, terms_per_query=4, seed=62)
    queries += ["", "zzzunknown"]
    return docs, queries


def _cfg(kind):
    return port_config.IndexConfig(
        scoring=port_config.ScoringConfig(kind=kind)
    )


def _dist(kind, n_shards, split_rows=None):
    eng = DistributedSearchEngine(
        _cfg(kind), mesh=make_mesh(n_shards, device="cpu")
    )
    eng.scorer = "fused"
    eng.split_rows = split_rows
    return eng


def _assert_same(got, want, what=""):
    np.testing.assert_array_equal(got[0], want[0], f"{what} ids")
    np.testing.assert_array_equal(got[1], want[1], f"{what} scores")


@pytest.mark.parametrize("device_build", [True, False])
def test_sharded_quantile_tables_match_jax_and_host(corpus, device_build):
    """The per-shard tables (global row space, per-shard local
    thresholds) == the JAX package's _sharded_quantiles over the same
    planes == host_row_doc_quantiles over each shard's local CSR
    scattered to global rows, the all-zero rows of terms a shard lacks
    included; a second call returns the cached objects."""
    from document_search_engine_tpu.parallel.dist import _sharded_quantiles

    docs, _q = corpus
    dist = DistributedSearchEngine(mesh=make_mesh(4, device="cpu"))
    dist.device_build = device_build
    dist.build(docs)
    idx = dist.index
    offs_h, offs_d, n_loc = dist._doc_quantiles()
    p = B.SPLIT_QUANTILES
    assert offs_h.shape == (idx.n_shards, idx.t_pad, p + 1)
    ref = RefDist(mesh=ref_mesh(4))
    ref.device_build = device_build
    ref.build(docs)
    np.testing.assert_array_equal(
        np.stack([t.numpy() for t in idx.post_doc]),
        np.asarray(ref.index.post_doc))
    rmesh = ref.mesh
    jax_offs = np.asarray(_sharded_quantiles(
        ref.index.post_doc, ref.index.indptr_d, ref.index.row_start_d,
        np.array(n_loc, np.int32).reshape(-1, 1), p=p, mesh_=rmesh,
    ))
    np.testing.assert_array_equal(offs_h, jax_offs)
    for i, h in enumerate(idx.hosts):
        csr_doc = h.post_doc
        if csr_doc is None:  # device-built: derive the host CSR
            a = B.AnalyzedDocs(hashes=h.doc_hashes, tfs=h.doc_tfs,
                               doc_ptr=h.doc_ptr, dl=h.dl)
            csr_doc = B.build_host_segment(a, h.doc_base).post_doc
        want = np.zeros((idx.t_pad, p + 1), np.int32)
        if h.n_terms:
            loc = B.host_row_doc_quantiles(h.indptr, csr_doc, p,
                                           h.n_docs)
            want[np.searchsorted(idx.stats.vocab, h.term_hash)] = loc
        np.testing.assert_array_equal(offs_h[i], want, f"shard {i}")
        np.testing.assert_array_equal(offs_d[i].numpy(), want)
    again = dist._doc_quantiles()
    assert again[0] is offs_h and again[1] is offs_d


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_split_invariance(corpus, n_shards):
    """split_rows forced low (every real query splits): equal to the
    unsplit sharded engine and the oracle at every shard count."""
    docs, queries = corpus
    orc = OracleEngine(_cfg("bm25"))
    orc.build(docs)
    want = orc.search(queries, k=10)
    base = _dist("bm25", n_shards)
    base.build(docs)
    _assert_same(base.search(queries, k=10), want, "unsplit")
    dist = _dist("bm25", n_shards, split_rows=2)
    dist.build(docs)
    _assert_same(dist.search(queries, k=10), want, "split")


def test_sharded_split_mixed_thresholds_and_stream(corpus):
    """Mixed split and unsplit queries in one batch through a
    preplan-seeded search_stream equal the single engine."""
    docs, queries = corpus
    single = SearchEngine(_cfg("tfidf"), device="cpu")
    single.build(docs)
    want = single.search(queries, k=10)
    for thr in (4, 16):
        dist = _dist("tfidf", 2, split_rows=thr)
        dist.build(docs)
        dist.preplan([queries], k=10)
        outs = list(dist.search_stream([queries[:6], queries[6:]], k=10))
        got = (np.concatenate([o[0] for o in outs]),
               np.concatenate([o[1] for o in outs]))
        _assert_same(got, want, f"thr={thr}")
        assert dist.plan_cache.hits >= 1, "preplan seeding missed"


def test_sharded_split_incremental_updates(corpus):
    """add_docs and delete_docs replace the planes: the quantile cache is
    dropped and the split engine stays equal to the single engine."""
    docs, queries = corpus
    single = SearchEngine(_cfg("bm25"), device="cpu")
    single.build(docs[:90])
    dist = _dist("bm25", 2, split_rows=2)
    dist.build(docs[:90])
    dist.search(queries[:2], k=5)  # fills the quantile cache
    assert dist._quant_cache is not None
    single.add_docs(docs[90:])
    dist.add_docs(docs[90:])
    assert dist._quant_cache is None
    single.delete_docs(list(range(10, 30)))
    dist.delete_docs(list(range(10, 30)))
    _assert_same(dist.search(queries, k=10), single.search(queries, k=10))
    # the cache holds only the live planes
    assert all(a is b for a, b in zip(dist._quant_cache[0],
                                      dist.index.post_doc))
