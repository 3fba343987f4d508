"""Doc-range splitting in the port against the reference: the device
doc-quantile tables (zero-length rows included), the split planner, the
piece form of the plan expansion, the plain scorer's doc limits and the
fused kernel's plain version with doc limits against the Pallas kernel's
dlim branch in interpret mode; then the engine with split_rows on
(every real query split, and a mixed threshold), over several segments
and an empty-vocabulary one, against the oracle and the JAX engine.
Exact equality throughout."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.corpus.synth import synth_corpus, synth_queries
from document_search_engine_tpu.engine.engine import SearchEngine as RefEngine
from document_search_engine_tpu.index import builder as ref_builder
from document_search_engine_tpu.ops import fused_pallas as ref_fused
from document_search_engine_tpu.ops import schedule as ref_schedule
from document_search_engine_tpu.ops.packed import (
    search_packed_tables as ref_tables,
)
from document_search_engine_tpu.oracle import OracleEngine
from document_search_engine_tpu_torch import SearchEngine
from document_search_engine_tpu_torch import config as port_config
from document_search_engine_tpu_torch.index import builder as port_builder
from document_search_engine_tpu_torch.ops import fused as port_fused
from document_search_engine_tpu_torch.ops import schedule as port_schedule
from document_search_engine_tpu_torch.ops.packed import search_packed_tables
from test_packed import make_aligned

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

SCALE = float(np.float32(2.0**16))
CLIP = float(np.float32(65075262.0))
P = 8


def _csr(rng, n_terms, n_docs, max_len, lo=1):
    lens = rng.integers(lo, max_len, n_terms)
    indptr = np.zeros(n_terms + 1, np.int32)
    np.cumsum(lens, out=indptr[1:])
    parts = [
        np.sort(rng.choice(n_docs, size=l, replace=False).astype(np.int32))
        for l in lens
    ]
    doc = np.concatenate(parts)
    val = rng.random(len(doc), dtype=np.float32) * 0.9 + 0.05
    return indptr, doc, val


@pytest.mark.parametrize("seed", [3, 4])
def test_device_row_doc_quantiles_match_reference(seed):
    """Rows of every length from 0 up (rows whose length is a multiple
    of 128 make the search probe the next row's records)."""
    rng = np.random.default_rng(seed)
    n_terms, n_docs = 40, 977
    indptr, post_doc, post_val = _csr(rng, n_terms, n_docs, 300, lo=0)
    d2, _v2, row_start = make_aligned(indptr, post_doc, post_val, n_docs)
    want = np.asarray(ref_builder.device_row_doc_quantiles(
        jnp.asarray(d2), jnp.asarray(indptr),
        jnp.asarray(row_start.astype(np.int32)), P, n_docs,
    ))
    got = port_builder.device_row_doc_quantiles(
        torch.from_numpy(d2), torch.from_numpy(indptr),
        torch.from_numpy(row_start.astype(np.int32)), P, n_docs,
    )
    assert got.dtype == torch.int32 and got.shape == (n_terms, P + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(),
        port_builder.host_row_doc_quantiles(indptr, post_doc, P, n_docs),
    )


def test_device_row_doc_quantiles_zero_length_row():
    """A zero-length row whose aligned start aliases its neighbour's
    records must give all-zero offsets (the reference's clamp)."""
    n_docs = 1000
    indptr = np.array([0, 0, 4], np.int32)
    row_start = np.array([0, 0], np.int32)
    flat = np.full(256, n_docs, np.int32)
    flat[:4] = (1, 5, 7, 900)
    want = np.asarray(ref_builder.device_row_doc_quantiles(
        jnp.asarray(flat.reshape(2, 128)), jnp.asarray(indptr),
        jnp.asarray(row_start), P, n_docs,
    ))
    got = port_builder.device_row_doc_quantiles(
        torch.from_numpy(flat.reshape(2, 128)), torch.from_numpy(indptr),
        torch.from_numpy(row_start), P, n_docs,
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 0).all()


@pytest.mark.parametrize("threshold", [1, 4, 16])
def test_split_pieces_matches_reference(threshold):
    rng = np.random.default_rng(threshold)
    n_terms, nq, s = 50, 300, 8
    lens_t = rng.integers(0, 3000, n_terms)
    offs = np.sort(rng.integers(0, 3000, (n_terms, P + 1)), axis=1)
    offs[:, 0] = 0
    offs[:, P] = lens_t
    offs = np.minimum(offs, lens_t[:, None]).astype(np.int32)
    rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
    lens = np.where(rng.random((nq, s)) < 0.8, lens_t[rows], 0)
    for block in (512, 4096):
        got = port_schedule.split_pieces(lens, rows, offs, threshold, block, P)
        want = ref_schedule.split_pieces(lens, rows, offs, threshold, block, P)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[0].shape[0] > nq  # some queries split
        plan_g = port_schedule.plan_batch(
            np.zeros(n_terms + 1), rows[got[0]], lens[got[0]] > 0,
            families=((None, block),), compact=True, lens=got[3],
        )
        plan_w = ref_schedule.plan_batch(
            np.zeros(n_terms + 1), rows[got[0]], lens[got[0]] > 0,
            families=((None, block),), compact=True, lens=got[3],
        )
        assert len(plan_g) == len(plan_w)
        for g, w in zip(plan_g, plan_w):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1:] == w[1:]


def _pieces(seed, m):
    """A CSR corpus, its quantile table, and nq queries cut into m pieces
    each: (d2, v2, row_start, indptr, offs, rows_p, coeff_p, cols, dlim,
    nb, block, s, n_docs)."""
    rng = np.random.default_rng(seed)
    n_terms, n_docs, nq, s, block = 25, 3000, 4, 4, 512
    indptr, post_doc, post_val = _csr(rng, n_terms, n_docs, 2000)
    d2, v2, row_start = make_aligned(indptr, post_doc, post_val, n_docs)
    offs = ref_builder.host_row_doc_quantiles(indptr, post_doc, P, n_docs)
    rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
    coeff = (rng.random((nq, s)) * 1.5).astype(np.float32)
    coeff[1, 2] = 0.0
    rows_p, coeff_p = np.repeat(rows, m, 0), np.repeat(coeff, m, 0)
    pno = np.tile(np.arange(m), nq)
    cols = np.stack([pno * P // m, (pno + 1) * P // m], 1).astype(np.int32)
    bounds = ref_builder.quantile_doc_bounds(P, n_docs)
    dlim = bounds[cols].astype(np.int32).reshape(-1, 1, 2)
    nb = ref_schedule.block_plan(indptr, rows, coeff > 0, block=block)
    return (d2, v2, row_start.astype(np.int32), indptr, offs, rows_p,
            coeff_p, cols, dlim, nb, block, s, n_docs)


@pytest.mark.parametrize("m", [2, 4, 8])
def test_expand_plan_tables_pieces_match_reference(m):
    (_d2, _v2, row_start, indptr, offs, rows_p, coeff_p, cols, _dlim, nb,
     block, _s, _n) = _pieces(13, m)
    want = ref_fused.expand_plan_tables(
        jnp.asarray(row_start), jnp.asarray(indptr), jnp.asarray(rows_p),
        jnp.asarray(coeff_p.view(np.int32)), nb, block,
        offs_dev=jnp.asarray(offs), cols=jnp.asarray(cols),
    )
    t = torch.from_numpy
    got = port_fused.expand_plan_tables(
        t(row_start), t(indptr), t(rows_p), t(coeff_p.view(np.int32)), nb,
        block, offs_dev=t(offs), cols=t(cols),
    )
    for name, g, w in zip(("srcrow", "rem", "abits", "dstrow"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)


@pytest.mark.parametrize("k", [10, 17])
def test_dlim_plain_versions_match_reference(k):
    """search_packed_tables(dlim) and fused_search(dlim) on CPU tensors
    against the reference twin and its Pallas kernel's dlim branch; the
    merged pieces equal the unsplit ranking."""
    m = 4
    (d2, v2, row_start, indptr, offs, rows_p, coeff_p, cols, dlim, nb,
     block, s, n_docs) = _pieces(13, m)
    sr, rm, ab, dst = ref_fused.plan_tables(
        row_start, indptr, rows_p, coeff_p, nb, block,
        lo=offs[rows_p, cols[:, 0:1]], hi=offs[rows_p, cols[:, 1:2]],
    )
    jt = jnp.asarray
    want_tw = ref_tables(
        jt(d2), jt(v2), jt(sr), jt(rm), jt(ab), jnp.float32(SCALE),
        jnp.float32(CLIP), jnp.int32(0), n_blocks=nb, block=block, s=s, k=k,
        n_docs=n_docs, dlim=jt(dlim),
    )
    want_k = ref_fused.fused_search_pallas(
        jt(d2), jt(v2), jt(sr), jt(rm), jt(ab), jt(dst), n_blocks=nb,
        block=block, s=s, k=k, n_docs=n_docs, scale=SCALE, clip=CLIP,
        r_c=None, q_stack=1, interpret=True, dlim=jt(dlim),
    )
    t = torch.from_numpy
    got_tw = search_packed_tables(
        t(d2), t(v2), t(sr), t(rm), t(ab), SCALE, CLIP, 0, n_blocks=nb,
        block=block, s=s, k=k, n_docs=n_docs, dlim=t(dlim),
    )
    launches = port_fused.fused_search.launches_dlim
    got_k = port_fused.fused_search(
        t(d2), t(v2), t(sr), t(rm), t(ab), t(dst), n_blocks=nb, block=block,
        s=s, k=k, n_docs=n_docs, scale=SCALE, clip=CLIP, r_c=64,
        key_bits=port_fused.key_bits_for(s, n_docs), dlim=t(dlim),
    )
    assert port_fused.fused_search.launches_dlim == launches  # CPU: plain
    np.testing.assert_array_equal(got_tw[0].numpy(), np.asarray(want_tw[0]))
    np.testing.assert_array_equal(got_tw[1].numpy(), np.asarray(want_tw[1]))
    np.testing.assert_array_equal(got_k[0].numpy(), np.asarray(want_k[0]))
    kv = np.asarray(want_k[0])
    np.testing.assert_array_equal(
        got_k[1].numpy(), np.where(kv > 0, np.asarray(want_k[1]), -1))
    # the merged pieces are the unsplit ranking
    nq = rows_p.shape[0] // m
    sr0, rm0, ab0, _ = ref_fused.plan_tables(
        row_start, indptr, rows_p[::m], coeff_p[::m], nb, block)
    whole = search_packed_tables(
        t(d2), t(v2), t(sr0), t(rm0), t(ab0), SCALE, CLIP, 0, n_blocks=nb,
        block=block, s=s, k=k, n_docs=n_docs,
    )
    pv = got_tw[0].numpy().reshape(nq, m * k)
    pg = got_tw[1].numpy().reshape(nq, m * k)
    order = np.lexsort((pg, -pv.astype(np.int64)), axis=-1)[:, :k]
    mv = np.take_along_axis(pv, order, 1)
    mg = np.take_along_axis(pg, order, 1)
    np.testing.assert_array_equal(np.where(mv > 0, mv, -1), whole[0].numpy())
    np.testing.assert_array_equal(np.where(mv > 0, mg, -1), whole[1].numpy())


@pytest.mark.parametrize("split_rows", [2, 4])
@pytest.mark.parametrize("kind", ["bm25", "tfidf"])
def test_split_engine_matches_oracle_and_reference(kind, split_rows):
    """The port's fused scorer with split_rows 2 (every real query
    splits) and 4 (a mixed population) over three segments, the last one
    empty-vocabulary, through preplan, search (k up to 200: k > 128 does
    not split) and search_stream; against the oracle and the JAX engine
    (its plain scorer: its split path interprets the Pallas kernel, and
    tests/test_split.py holds that path to the oracle)."""
    docs = synth_corpus(n_docs=300, vocab_size=150, mean_len=25, seed=91)
    queries = synth_queries(docs, n_queries=10, terms_per_query=3, seed=92)
    queries += ["", "zzznotaword"]
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    eng = SearchEngine(port_config.IndexConfig.from_json(cfg.to_json()),
                       device="cpu")
    ref, ora = RefEngine(cfg), OracleEngine(cfg)
    eng.scorer, eng.split_rows = "fused", split_rows
    ref.scorer = "xla"
    for e in (eng, ref, ora):
        e.build(docs[:200])
        e.add_docs(docs[200:])
        e.add_docs(["", "  ", ""])
    eng.preplan([queries], k=10)
    for k in (1, 10, 17, 200):
        want = ora.search(queries, k=k)
        got = eng.search(queries, k=k)
        np.testing.assert_array_equal(got[0], want[0], f"k={k}")
        np.testing.assert_array_equal(got[1], want[1], f"k={k}")
    ref_got = ref.search(queries, k=10)
    want = ora.search(queries, k=10)
    np.testing.assert_array_equal(ref_got[0], want[0], "reference")
    np.testing.assert_array_equal(ref_got[1], want[1], "reference")
    got = list(eng.search_stream([queries[:4], [], queries[4:]], k=10))
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got]),
                                  want[0])
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got]),
                                  want[1])
    # queries did split: some segment's plan rows are pieces
    fut = eng._dispatch(eng.frontend.analyze_rows(queries, eng.stats), 10)
    assert any(pm is not None and pm[2] > 1 for pm in fut[2])
    assert eng.plan_cache.hits >= 1
