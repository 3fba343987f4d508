"""The port's reference scorers against the JAX package's: the dense exact
scorer (ops/exact.py) and the dense rankers (ops/topk.py topk_ranked,
topk_ranked_sort), the gather- and slice-packed scorers (ops/packed.py
search_packed, search_packed_ds, with pack_ds ranked by the rank-only
kernel's wrapper), the budgets (total_cap, row_cap, ops/schedule.py
block_plan, blocks_per_query) and the query frontend's analyze and
analyze_slow. Same seeded numpy inputs on both sides; ids, int32 scores
and budgets must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from document_search_engine_tpu.ops import exact as ref_exact
from document_search_engine_tpu.ops import packed as ref_packed
from document_search_engine_tpu.ops import schedule as ref_schedule
from document_search_engine_tpu.ops import topk as ref_topk
from document_search_engine_tpu_torch.ops import exact as port_exact
from document_search_engine_tpu_torch.ops import packed as port_packed
from document_search_engine_tpu_torch.ops import schedule as port_schedule
from document_search_engine_tpu_torch.ops import topk as port_topk
from document_search_engine_tpu_torch.ops.rank import (
    rank_candidates_kernel,
    rank_kernel,
)
from test_packed import make_aligned, make_csr

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

SCALE = float(np.float32(2.0**16))
CLIP = float(np.float32(65075262))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _ref_dense(indptr, post_doc, post_val, rows, coeff, cap, d_pad):
    return ref_exact.score_exact(
        jnp.asarray(indptr), jnp.asarray(post_doc), jnp.asarray(post_val),
        jnp.asarray(rows), jnp.asarray(coeff), jnp.float32(SCALE),
        jnp.float32(CLIP), cap=cap, n_docs_pad=d_pad,
    )


def _dense_case(seed):
    """Random CSR with tombstones and missing slots (tests/test_packed.py's
    case), plus a query whose slots repeat one row and an empty one."""
    rng = np.random.default_rng(seed)
    n_terms, n_docs, d_pad = 40, 200, 256
    indptr, post_doc, post_val = make_csr(rng, n_terms, n_docs)
    alive = np.ones(d_pad, bool)
    alive[n_docs:] = False
    alive[rng.integers(0, n_docs, 10)] = False
    nq, s = 8, 6
    rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
    coeff = rng.random((nq, s)).astype(np.float32) * 1.5
    coeff[rng.random((nq, s)) < 0.2] = 0.0
    rows[6] = rows[6, 0]  # one row in every slot
    coeff[6] = [0.5, 0.25, 0.125, 0.0, 1.0, 0.75]
    rows[7], coeff[7] = 0, 0.0  # empty query
    return indptr, post_doc, post_val, alive, rows, coeff, d_pad


@pytest.mark.parametrize("seed", [3, 5])
def test_score_exact_and_topk_ranked_match_reference(seed):
    indptr, post_doc, post_val, alive, rows, coeff, d_pad = _dense_case(seed)
    found = coeff > 0
    cap = port_exact.row_cap(indptr, rows[found])
    assert cap == ref_exact.row_cap(indptr, rows[found])
    got = port_exact.score_exact(
        _t(indptr), _t(post_doc), _t(post_val), _t(rows), _t(coeff), SCALE,
        CLIP, cap=cap, n_docs_pad=d_pad,
    )
    want = _ref_dense(indptr, post_doc, post_val, rows, coeff, cap, d_pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[7] == 0).all() and (got[6] > 0).any()
    gid_cols = np.arange(d_pad, dtype=np.int32) + 1000
    for k in (1, 5, 20, 300):
        _eq(port_topk.topk_ranked(got, _t(alive), _t(gid_cols), k=k),
            ref_topk.topk_ranked(want, jnp.asarray(alive),
                                 jnp.asarray(gid_cols), k=k))


@pytest.mark.parametrize("k", [1, 10, 100, 600])
def test_topk_ranked_ties_and_dead_columns(k):
    """Rows full of ties, dead columns and k beyond the row: topk_ranked
    == topk_ranked_sort == the reference's."""
    rng = np.random.default_rng(k)
    d = 512
    scores = rng.integers(-1, 4, size=(6, d)).astype(np.int32)
    scores[0] = 2  # one tie across the whole row
    scores[1] = 0  # nothing matches
    alive = rng.random(d) > 0.3
    doc_ids = (np.arange(d) + 1000).astype(np.int32)
    want = ref_topk.topk_ranked(jnp.asarray(scores), jnp.asarray(alive),
                                jnp.asarray(doc_ids), k=k)
    for fn in (port_topk.topk_ranked, port_topk.topk_ranked_sort):
        got = fn(_t(scores), _t(alive), _t(doc_ids), k=k)
        assert got[0].shape == (6, k) and got[0].dtype == torch.int32
        _eq(got, want)
    _eq(port_topk.topk_ranked_sort(_t(scores), _t(alive), _t(doc_ids), k=k),
        ref_topk.topk_ranked_sort(jnp.asarray(scores), jnp.asarray(alive),
                                  jnp.asarray(doc_ids), k=k))


def _ds_case(seed, blocksize):
    """tests/test_packed.py's aligned-plane case: CSR rows of up to 2,500
    unique docs, their (X, 128) planes and row starts, 5 queries of 3
    slots (one missing)."""
    rng = np.random.default_rng(seed)
    n_terms, n_docs = 25, 3000
    lens = rng.integers(1, 2500, n_terms)
    indptr64 = np.zeros(n_terms + 1, np.int64)
    np.cumsum(lens, out=indptr64[1:])
    nnz = int(indptr64[-1])
    post_doc = np.concatenate([
        np.sort(rng.choice(n_docs, size=l, replace=False).astype(np.int32))
        for l in lens
    ])
    post_val = rng.random(nnz, dtype=np.float32) * 0.9 + 0.05
    indptr = indptr64.astype(np.int32)
    d2, v2, row_start = make_aligned(indptr, post_doc, post_val, n_docs)
    nq, s = 5, 3
    rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
    coeff = rng.random((nq, s)).astype(np.float32) * 1.5
    coeff[1, 1] = 0.0
    pad = nnz + blocksize
    pd = np.concatenate([post_doc, np.full(pad - nnz, n_docs, np.int32)])
    pv = np.concatenate([post_val, np.zeros(pad - nnz, np.float32)])
    return dict(indptr=indptr, pd=pd, pv=pv, d2=d2, v2=v2,
                row_start=row_start, rows=rows, coeff=coeff, n_docs=n_docs)


@pytest.mark.parametrize("blocksize", [512, 2048])
def test_packed_scorers_match_reference(blocksize):
    c = _ds_case(21, blocksize)
    indptr, rows, coeff, n_docs = c["indptr"], c["rows"], c["coeff"], (
        c["n_docs"])
    found = coeff > 0
    c_total = port_packed.total_cap(indptr, rows, found)
    assert c_total == ref_packed.total_cap(indptr, rows, found)
    nb = port_schedule.block_plan(indptr, rows, found, block=blocksize)
    assert nb == ref_schedule.block_plan(indptr, rows, found,
                                         block=blocksize)
    assert nb * blocksize <= 8192  # the interpret-mode rank stays small
    sc, cl = jnp.float32(SCALE), jnp.float32(CLIP)
    want = ref_packed.search_packed(
        jnp.asarray(indptr), jnp.asarray(c["pd"]), jnp.asarray(c["pv"]),
        jnp.asarray(rows), jnp.asarray(coeff), sc, cl, jnp.int32(100),
        c_total=c_total, k=15, n_docs=n_docs,
    )
    _eq(port_packed.search_packed(
        _t(indptr), _t(c["pd"]), _t(c["pv"]), _t(rows), _t(coeff), SCALE,
        CLIP, 100, c_total=c_total, k=15, n_docs=n_docs), want)
    # the gather from row_start-aligned rows of the flat planes
    d_flat, v_flat = c["d2"].reshape(-1), c["v2"].reshape(-1).view(
        np.float32)
    _eq(port_packed.search_packed(
        _t(indptr), _t(d_flat), _t(v_flat), _t(rows), _t(coeff), SCALE,
        CLIP, 100, c_total=c_total, k=15, n_docs=n_docs,
        row_start=_t(c["row_start"])), want)
    ds_args = [c["d2"], c["v2"], indptr, c["row_start"], rows, coeff]
    for rank_kernel_route in (False, True):
        ref = ref_packed.search_packed_ds(
            *map(jnp.asarray, ds_args), sc, cl, jnp.int32(100),
            n_blocks=nb, k=15, n_docs=n_docs, block=blocksize,
            use_rank_pallas=rank_kernel_route,
            rank_interpret=rank_kernel_route,
        )
        _eq(ref, want)
        args = [*map(_t, ds_args), SCALE, CLIP]
        if rank_kernel_route:
            d_key, ci = port_packed.pack_ds(
                *args, n_blocks=nb, n_docs=n_docs, block=blocksize)
            launches = rank_kernel.launches
            got = rank_candidates_kernel(d_key, ci, 100, block=blocksize,
                                         s=rows.shape[1], k=15, n_docs=n_docs)
            assert rank_kernel.launches == launches  # CPU: the plain version
        else:
            got = port_packed.search_packed_ds(
                *args, 100, n_blocks=nb, k=15, n_docs=n_docs,
                block=blocksize)
        _eq(got, ref)


def test_pack_ds_layout_and_rank_route_at_larger_budgets():
    """pack_ds's buffers are block-run sorted with sentinel tails (the
    rank-only kernel's precondition), and pack_ds + the kernel's wrapper
    on CPU tensors == the plain search_packed_ds == the gather-packed
    scorer, at n_blocks above the batch's need and k past the hits."""
    c = _ds_case(7, 512)
    indptr, rows, coeff, n_docs = c["indptr"], c["rows"], c["coeff"], (
        c["n_docs"])
    found = coeff > 0
    want = port_packed.search_packed(
        _t(indptr), _t(c["pd"]), _t(c["pv"]), _t(rows), _t(coeff), SCALE,
        CLIP, 0, c_total=port_packed.total_cap(indptr, rows, found), k=128,
        n_docs=n_docs)
    nb0 = port_schedule.block_plan(indptr, rows, found, block=512)
    args = [*map(_t, [c["d2"], c["v2"], indptr, c["row_start"], rows,
                      coeff]), SCALE, CLIP]
    for nb in (nb0, 4 * nb0):
        d_key, ci = port_packed.pack_ds(*args, n_blocks=nb, n_docs=n_docs)
        runs = d_key.reshape(5, nb, 512)
        assert (runs[:, :, 1:] >= runs[:, :, :-1]).all()
        assert (ci[d_key == n_docs] == 0).all()
        np.testing.assert_array_equal(
            port_schedule.blocks_per_query(indptr, rows, found, 512),
            (runs[:, :, 0] < n_docs).sum(1).numpy())
        _eq(rank_candidates_kernel(d_key, ci, 0, block=512, s=3, k=128,
                                   n_docs=n_docs), want)
        _eq(port_packed.search_packed_ds(*args, 0, n_blocks=nb, k=128,
                                         n_docs=n_docs), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_budgets_match_reference(seed):
    rng = np.random.default_rng(seed)
    n_terms = int(rng.integers(1, 60))
    lens = rng.integers(0, 5000, n_terms)
    indptr = np.zeros(n_terms + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    for nq, s in ((0, 4), (1, 1), (37, 8)):
        rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
        found = rng.random((nq, s)) < 0.7
        assert port_packed.total_cap(indptr, rows, found) == (
            ref_packed.total_cap(indptr, rows, found))
        assert port_exact.row_cap(indptr, rows[found]) == (
            ref_exact.row_cap(indptr, rows[found]))
        for block in (128, 512, 4096):
            assert port_schedule.block_plan(indptr, rows, found, block) == (
                ref_schedule.block_plan(indptr, rows, found, block))
            np.testing.assert_array_equal(
                port_schedule.blocks_per_query(indptr, rows, found, block),
                ref_schedule.blocks_per_query(indptr, rows, found, block))
    empty = np.zeros(1, np.int64)
    rows = np.zeros((3, 2), np.int32)
    assert port_schedule.block_plan(empty, rows, rows > 0) == 1
    assert port_packed.total_cap(empty, rows, rows > 0) == 16


@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_analyze_and_analyze_slow_match_reference(kind):
    from document_search_engine_tpu.config import IndexConfig as RefC
    from document_search_engine_tpu.config import ScoringConfig as RefS
    from document_search_engine_tpu.engine.query import (
        QueryFrontend as RefFrontend,
    )
    from document_search_engine_tpu.index import builder as ref_b
    from document_search_engine_tpu.index.csr import (
        merge_stats as ref_merge,
    )
    from document_search_engine_tpu_torch.config import (
        IndexConfig,
        ScoringConfig,
    )
    from document_search_engine_tpu_torch.corpus.synth import (
        synth_corpus,
        synth_queries,
    )
    from document_search_engine_tpu_torch.engine.query import QueryFrontend
    from document_search_engine_tpu_torch.index import builder as port_b
    from document_search_engine_tpu_torch.index.csr import merge_stats

    docs = synth_corpus(n_docs=80, vocab_size=400, mean_len=30, seed=13)
    queries = synth_queries(docs, n_queries=12, terms_per_query=5, seed=14)
    queries += ["", "zzznotaword", "naïve café " + docs[0][:40],
                " ".join(docs[1].split()[:60])]  # more terms than slots
    cfg, ref_cfg = (IndexConfig(scoring=ScoringConfig(kind=kind)),
                    RefC(scoring=RefS(kind=kind)))
    stats = merge_stats([port_b.build_host_segment(
        port_b.analyze_texts_fast(part, cfg), base)
        for base, part in ((0, docs[:50]), (50, docs[50:]))])
    ref_stats = ref_merge([ref_b.build_host_segment(
        ref_b.analyze_texts_fast(part, ref_cfg), base)
        for base, part in ((0, docs[:50]), (50, docs[50:]))])
    port, ref = QueryFrontend(cfg), RefFrontend(ref_cfg)
    want = ref.analyze(queries, ref_stats)
    for got in (port.analyze(queries, stats),
                port.analyze_slow(queries, stats)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for g, w in zip(port.analyze_slow(queries, stats),
                    ref.analyze_slow(queries, ref_stats)):
        np.testing.assert_array_equal(g, w)
