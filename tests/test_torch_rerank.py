"""The torch port's hybrid rerank path (ops/rerank.py and
SearchEngine.search_rerank) against the JAX package, on the CPU, bit for
bit: the device embedding build (torch scatter-add vs the JAX scatter-add
and the host reference), the candidate gather + dots (the plain version
vs the JAX Pallas kernel in interpret mode), the host query embeddings
and ordering, and search_rerank end to end over segments carried across
from a JAX engine (index/convert.py), so the comparison sees the same
index bits on both sides. Every compared value is an integer:
tolerance 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.corpus.synth import synth_corpus, synth_queries
from document_search_engine_tpu.engine.engine import (
    SearchEngine as RefEngine,
)
from document_search_engine_tpu.index.builder import (
    _host_planes,
    aligned_geometry,
)
from document_search_engine_tpu.ops import rerank as ref_rerank
from document_search_engine_tpu_torch import SearchEngine
from document_search_engine_tpu_torch import config as port_config
from document_search_engine_tpu_torch.index.convert import (
    DEVICE_FIELDS,
    segment_from_reference,
)
from document_search_engine_tpu_torch.ops import rerank as port_rerank

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)


def _random_csr(seed, n_terms, n_docs, max_len):
    rng = np.random.default_rng(seed)
    term_hash = np.sort(rng.integers(1, 2**63, n_terms).astype(np.uint64))
    lens = rng.integers(0, max_len, n_terms)
    indptr = np.zeros(n_terms + 1, np.int32)
    np.cumsum(lens, out=indptr[1:])
    post_doc = np.concatenate(
        [np.sort(rng.choice(n_docs, size=l, replace=False)) for l in lens]
    ).astype(np.int32)
    # values up to 4.0 reach the +-63 clip once a few terms share a cell
    post_val = rng.random(int(indptr[-1]), dtype=np.float32) * 4.0
    return term_hash, indptr, post_doc, post_val


@pytest.mark.parametrize("dim,chunk_rows", [(64, 3), (256, None)])
def test_device_embeddings_match_jax_and_host(dim, chunk_rows, monkeypatch):
    if chunk_rows:  # the scatter in several chunks of plane rows
        monkeypatch.setattr(port_rerank, "CHUNK_ROWS", chunk_rows)
    n_terms, n_docs = 40, 300
    term_hash, indptr, post_doc, post_val = _random_csr(
        dim, n_terms, n_docs, 60
    )
    nnz = int(indptr[-1])
    row_start, x_rows = aligned_geometry(indptr, 1)
    d2, v2, _ = _host_planes(
        post_doc, post_val, np.ones(nnz, np.int32), indptr, row_start,
        x_rows, n_docs,
    )
    col, sign = ref_rerank.term_projection(term_hash, dim)
    want_emb, want_ssq = ref_rerank.device_doc_embeddings_int(
        jnp.asarray(d2), jnp.asarray(v2),
        jnp.asarray(row_start.astype(np.int32)),
        jnp.asarray(col), jnp.asarray(sign), n_docs=n_docs, dim=dim,
    )
    p_col, p_sign = port_rerank.term_projection(term_hash, dim)
    np.testing.assert_array_equal(p_col, col)
    np.testing.assert_array_equal(p_sign, sign)
    got_emb, got_ssq = port_rerank.device_doc_embeddings_int(
        torch.from_numpy(np.asarray(d2)), torch.from_numpy(np.asarray(v2)),
        torch.from_numpy(row_start.astype(np.int32)),
        torch.from_numpy(p_col), torch.from_numpy(p_sign),
        n_docs=n_docs, dim=dim,
    )
    assert got_emb.dtype == torch.int8 and got_ssq.dtype == torch.int32
    host_emb, host_ssq = port_rerank.doc_embeddings_int(
        term_hash, indptr, post_doc, post_val, n_docs, dim
    )
    ref_host = ref_rerank.doc_embeddings_int(
        term_hash, indptr, post_doc, post_val, n_docs, dim
    )
    for emb, ssq in ((np.asarray(want_emb), np.asarray(want_ssq)),
                     (host_emb, host_ssq), ref_host):
        np.testing.assert_array_equal(got_emb.numpy(), emb)
        np.testing.assert_array_equal(got_ssq.numpy(), ssq)
    assert np.abs(host_emb).max() == port_rerank.EMB_CLIP  # clip reached


@pytest.mark.parametrize("dim,kc", [(64, 16), (256, 64)])
def test_gather_and_dot_matches_pallas_interpret(dim, kc):
    rng = np.random.default_rng(dim + kc)
    n_docs, nq = 500, 12
    clip = port_rerank.EMB_CLIP
    emb = rng.integers(-clip, clip + 1, (n_docs, dim)).astype(np.int8)
    ssq = (emb.astype(np.int32) ** 2).sum(1).astype(np.int32)
    qemb = rng.integers(-clip, clip + 1, (nq, dim)).astype(np.int8)
    gids = rng.integers(0, n_docs, (nq, kc)).astype(np.int32)
    gids[rng.random((nq, kc)) < 0.2] = -1  # dead candidates
    gids[:, 1] = gids[:, 0]  # repeated gids
    gids[2] = -1  # a query without candidates
    want = ref_rerank.gather_and_dot(
        jnp.asarray(emb), jnp.asarray(ssq), jnp.asarray(qemb),
        jnp.asarray(gids), interpret=True,
    )
    launches = port_rerank.gather_and_dot.launches
    got = port_rerank.gather_and_dot(*map(torch.from_numpy,
                                          (emb, ssq, qemb, gids)))
    assert port_rerank.gather_and_dot.launches == launches  # plain on CPU
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == (nq, kc)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    exact = np.einsum("qe,qke->qk", qemb.astype(np.int64),
                      emb[np.maximum(gids, 0)].astype(np.int64))
    np.testing.assert_array_equal(got[0].numpy(), exact)


def test_query_embeddings_and_order_match_jax():
    rng = np.random.default_rng(5)
    nq, s, kc = 30, 8, 24
    slot_h = rng.integers(1, 2**63, (nq, s)).astype(np.uint64)
    coeff = (rng.random((nq, s)) * 3.0).astype(np.float32)
    coeff[rng.random((nq, s)) < 0.3] = 0.0
    slot_h[coeff == 0] = 0
    coeff[3] = 0.0  # a query with no slots
    for dim in (64, 256):
        got = port_rerank.query_embeddings_int(slot_h, coeff, dim)
        want = ref_rerank.query_embeddings_int(slot_h, coeff, dim)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    dots = rng.integers(-3000, 3000, (nq, kc)).astype(np.int32)
    dots[:, 1] = dots[:, 0]  # rerank ties: lexical, then gid decides
    ssq_q = rng.integers(0, 10**5, nq).astype(np.int64)
    ssq_d = rng.integers(0, 10**5, (nq, kc)).astype(np.int32)
    lex = rng.integers(-1, 10**6, (nq, kc)).astype(np.int64)
    lex[:, 2] = lex[:, 3]
    gids = rng.integers(0, 10**4, (nq, kc)).astype(np.int64)
    for k in (1, 10, kc):
        got = port_rerank.rerank_order_int(dots, ssq_q, ssq_d, lex, gids, k)
        want = ref_rerank.rerank_order_int(dots, ssq_q, ssq_d, lex, gids, k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _carried(ref):
    return [
        segment_from_reference(
            host, {f: np.asarray(getattr(dev, f)) for f in DEVICE_FIELDS},
            "cpu",
        )
        for host, dev in ref.segments
    ]


@pytest.mark.parametrize("kind", ["bm25", "tfidf"])
@pytest.mark.parametrize("k,cand,empty_seg", [(10, 64, False), (5, 16, True)])
def test_search_rerank_matches_jax_engine(kind, k, cand, empty_seg):
    docs = synth_corpus(n_docs=150, vocab_size=500, mean_len=30, seed=31)
    queries = synth_queries(docs, n_queries=14, terms_per_query=4, seed=32)
    queries += ["", "zzznotaword", docs[0].split()[0]]
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    ref = RefEngine(cfg)
    ref.build(docs[:100])
    ref.add_docs(docs[100:])
    if empty_seg:
        ref.add_docs(["", "!!! ???"])  # a segment with no vocabulary
    want = ref.search_rerank(queries, k=k, candidates=cand)
    pcfg = port_config.IndexConfig.from_json(cfg.to_json())
    for mode in ("plain", "fused"):
        eng = SearchEngine(pcfg, device="cpu")
        eng.scorer = mode
        eng.load_segments(_carried(ref))
        got = eng.search_rerank(queries, k=k, candidates=cand)
        for g, w, name in zip(got, want, ("ids", "rerank", "lexical")):
            assert g.shape == (len(queries), k)
            np.testing.assert_array_equal(g, np.asarray(w),
                                          f"{kind} {mode} {name}")
    assert (got[0][:, 0] >= 0).sum() >= len(queries) - 2


def test_embedding_cache_follows_the_index():
    """The embedding table is cached per dim, dropped by add_docs (the
    stats refresh) and by load_segments, and equals the host reference
    over the segment's own postings."""
    docs = synth_corpus(n_docs=60, vocab_size=300, mean_len=25, seed=41)
    queries = synth_queries(docs, n_queries=6, seed=42)
    eng = SearchEngine(port_config.IndexConfig(
        scoring=port_config.ScoringConfig(kind="bm25")), device="cpu")
    eng.build(docs[:40])
    first = eng.search_rerank(queries, k=5, candidates=16)
    emb, ssq = eng._emb_cache[256]
    host, dev = eng.segments[0]
    flat_d = dev.post_doc.reshape(-1).numpy()
    flat_v = dev.post_val.reshape(-1).numpy().view(np.float32)
    keep = np.concatenate([
        np.arange(host.row_start[t], host.row_start[t]
                  + host.indptr[t + 1] - host.indptr[t])
        for t in range(host.n_terms)
    ]).astype(np.int64)
    want = port_rerank.doc_embeddings_int(
        host.term_hash, host.indptr, flat_d[keep], flat_v[keep],
        host.n_docs, 256,
    )
    np.testing.assert_array_equal(emb.numpy(), want[0])
    np.testing.assert_array_equal(ssq.numpy(), want[1])
    assert eng._device_embeddings(256)[0] is emb  # cached
    eng.add_docs(docs[40:])
    assert eng._emb_cache == {}
    eng.search_rerank(queries, k=5, candidates=16)
    assert eng._emb_cache[256][0].shape == (60, 256)
    eng.load_segments([list(seg) for seg in eng.segments[:1]])
    assert eng._emb_cache == {}
    again = eng.search_rerank(queries, k=5, candidates=16)
    assert eng._emb_cache[256][0].shape == (40, 256)
    # one segment again, its values now refreshed against 60 docs' stats
    assert again[0].shape == first[0].shape
