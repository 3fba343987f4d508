"""The torch port's device build against the JAX reference build: the
same analyzed corpus must give the same indptr, row_start, doc and tf
plane bits as the reference's device build, shape-bucketed sentinel
padding included, and value-plane bits equal to the reference's host
build, whose values are oracle/spec.py's numpy arithmetic. (The
reference's jitted device materialization on XLA:CPU lands 1 ulp off
the spec on a fraction of a percent of bm25 postings, though its
exact_div alone is exact there — the mark of a mul+add contraction
across ops; the tests pin that the port differs from it exactly there
and nowhere else.) Also: the
port's exact_div equals numpy's correctly rounded f32 division."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.corpus.synth import synth_corpus
from document_search_engine_tpu.index import builder as ref_builder
from document_search_engine_tpu.index.csr import (
    merge_stats as ref_merge_stats,
)
from document_search_engine_tpu_torch.index import builder as port_builder
from document_search_engine_tpu_torch.index.csr import (
    merge_stats as port_merge_stats,
)

DEVICE_FIELDS = (
    "indptr", "row_start", "post_doc", "post_val", "post_tf", "dl",
    "alive", "inv_norm",
)


def _bits(a):
    a = np.asarray(a)
    # float fields compare as bits: +0.0 padding vs -0.0 would differ
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_segments_equal(ref_seg, port_seg, spec_vals, what):
    """Port segment == reference device segment in every field but the
    value plane, which must equal `spec_vals` (the reference host
    build's plane, unbucketed) on its true prefix and be +0.0 after."""
    rh, rd = ref_seg
    ph, pd = port_seg
    for f in ("term_hash", "df", "dl", "alive", "indptr", "row_start"):
        np.testing.assert_array_equal(
            getattr(ph, f), getattr(rh, f), f"{what} host {f}"
        )
    assert ph.n_docs == rh.n_docs and ph.doc_base == rh.doc_base
    for f in DEVICE_FIELDS:
        want = np.asarray(getattr(rd, f))
        got = getattr(pd, f).numpy()
        assert got.shape == want.shape, (what, f, got.shape, want.shape)
        assert got.dtype == want.dtype, (what, f, got.dtype, want.dtype)
        if f != "post_val":
            np.testing.assert_array_equal(
                _bits(got), _bits(want), f"{what} device {f}"
            )
    got = pd.post_val.numpy()
    hx = spec_vals.shape[0]
    np.testing.assert_array_equal(got[:hx], spec_vals, f"{what} post_val")
    assert (got[hx:] == 0).all(), what
    # the reference device plane differs from the port only where it
    # differs from its own host (spec) plane
    ref_v = np.asarray(rd.post_val)
    off_spec = ref_v[:hx] != spec_vals
    np.testing.assert_array_equal(
        (got[:hx] != ref_v[:hx]), off_spec, f"{what} off-spec positions"
    )
    assert off_spec.mean() < 0.01, what


@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_build_segment_device_matches_reference(kind):
    docs = synth_corpus(n_docs=150, vocab_size=600, mean_len=30, seed=21)
    docs.append("")  # an empty doc: dl 0, no postings
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    analyzed_r = ref_builder.analyze_texts_fast(docs, cfg)
    analyzed_p = port_builder.analyze_texts_fast(docs, cfg)
    for f in ("hashes", "tfs", "doc_ptr", "dl"):
        np.testing.assert_array_equal(
            getattr(analyzed_p, f), getattr(analyzed_r, f), f
        )
    ref = ref_builder.build_segment_device(analyzed_r, cfg, doc_base=7)
    port = port_builder.build_segment_device(
        analyzed_p, cfg, torch.device("cpu"), doc_base=7
    )
    _hh, hd = ref_builder.build_segment(analyzed_r, cfg, doc_base=7)
    _assert_segments_equal(ref, port, np.asarray(hd.post_val), kind)
    # the bucketed padding is really there, and really sentinel
    ph, pd = port
    n_terms = ph.n_terms
    assert pd.row_start.shape[0] > n_terms
    assert (pd.row_start[n_terms:] == pd.post_doc.numel()).all()
    assert (pd.indptr[n_terms + 1 :] == int(ph.indptr[-1])).all()


@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_refresh_segment_vals_matches_reference(kind):
    """Two segments re-materialized against merged global stats (the
    add_docs path): the value planes must stay bit-identical."""
    docs = synth_corpus(n_docs=90, vocab_size=300, mean_len=25, seed=23)
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    ref_segs, port_segs, analyzed = [], [], []
    for base, part in ((0, docs[:50]), (50, docs[50:])):
        a = ref_builder.analyze_texts_fast(part, cfg)
        analyzed.append((a, base))
        ref_segs.append(ref_builder.build_segment_device(a, cfg, base))
        port_segs.append(
            port_builder.build_segment_device(a, cfg, "cpu", base)
        )
    ref_stats = ref_merge_stats([h for h, _ in ref_segs])
    port_stats = port_merge_stats([h for h, _ in port_segs])
    np.testing.assert_array_equal(port_stats.vocab, ref_stats.vocab)
    np.testing.assert_array_equal(port_stats.df, ref_stats.df)
    for i, (rs, ps, (a, base)) in enumerate(
        zip(ref_segs, port_segs, analyzed)
    ):
        rd = ref_builder.refresh_segment_vals(rs[0], rs[1], cfg, ref_stats)
        pd = port_builder.refresh_segment_vals(ps[0], ps[1], cfg, port_stats)
        # the spec values under the merged stats: the host build
        _hh, hd = ref_builder.build_segment(a, cfg, base, stats=ref_stats)
        _assert_segments_equal(
            (rs[0], rd), (ps[0], pd), np.asarray(hd.post_val),
            f"{kind} seg {i}",
        )


def test_device_pack_masks_sentinels_like_reference():
    """Sentinel triples (row == n_terms, doc == n_docs) are dropped from
    the df/dl scatters explicitly, where JAX dropped them as out of
    range: all six outputs equal the reference's."""
    rng = np.random.default_rng(3)
    n_terms, n_docs, nnz, pad = 37, 50, 400, 60
    rows = rng.integers(0, n_terms, nnz).astype(np.int32)
    docs = rng.integers(0, n_docs, nnz).astype(np.int32)
    # (row, doc) pairs are unique in a real CSR build
    key = np.unique(rows.astype(np.int64) * n_docs + docs)
    rows = (key // n_docs).astype(np.int32)
    docs = (key % n_docs).astype(np.int32)
    perm = rng.permutation(len(rows))
    rows, docs = rows[perm], docs[perm]
    tfs = rng.integers(1, 5, len(rows)).astype(np.int32)
    rows = np.concatenate([rows, np.full(pad, n_terms, np.int32)])
    docs = np.concatenate([docs, np.full(pad, n_docs, np.int32)])
    tfs = np.concatenate([tfs, np.zeros(pad, np.int32)])
    want = ref_builder.device_pack(
        jnp.asarray(rows), jnp.asarray(docs), jnp.asarray(tfs),
        n_terms=n_terms, n_docs=n_docs,
    )
    got = port_builder.device_pack(
        torch.from_numpy(rows), torch.from_numpy(docs),
        torch.from_numpy(tfs), n_terms=n_terms, n_docs=n_docs,
    )
    for name, g, w in zip(("r", "d", "t", "indptr", "df", "dl"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)


def test_exact_div_matches_numpy():
    """Structured and random f32 samples: the port's exact_div and
    torch's plain f32 division both equal numpy's correctly rounded
    quotient bit for bit (the port keeps exact_div op for op)."""
    rng = np.random.default_rng(11)
    f32 = np.float32
    # the bm25 shape: (tf * (k1+1)) / (tf + K(dl)) over realistic ranges
    tf = rng.integers(1, 200, 200_000).astype(f32)
    k_doc = (f32(0.54) + f32(0.0102) * rng.integers(1, 3000, 200_000)
             .astype(f32)).astype(f32)
    a1, b1 = (tf * f32(1.9)).astype(f32), (tf + k_doc).astype(f32)
    # wide-exponent random operands, and exact/tie-prone quotients
    a2 = (rng.random(200_000, dtype=f32) + f32(0.01)) * f32(2.0) ** (
        rng.integers(-20, 20, 200_000).astype(f32))
    b2 = (rng.random(200_000, dtype=f32) + f32(0.01)) * f32(2.0) ** (
        rng.integers(-20, 20, 200_000).astype(f32))
    ints = rng.integers(1, 1 << 24, 100_000).astype(f32)
    a3, b3 = (ints * f32(3.0)).astype(f32), np.full(100_000, f32(3.0))
    a = np.concatenate([a1, a2.astype(f32), a3])
    b = np.concatenate([b1, b2.astype(f32), b3])
    want = (a / b).astype(f32).view(np.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = port_builder.exact_div(ta, tb).numpy().view(np.int32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal((ta / tb).numpy().view(np.int32), want)
