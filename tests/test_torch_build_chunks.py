"""The torch port's chunked device build: device_pack,
device_align_planes and device_materialize_vals at chunk sizes small
enough to force many chunks give the bits of the whole-plane bodies
they replaced (test-local copies below) and of the JAX reference, and
the sharded build step gives the planes and df of its former inline
body at 1, 2 and 4 shards and frees each shard's uploaded triples once
packed. A TorchDispatchMode checks the memory bound
in a form the CPU can see: apart from the outputs each stage
preallocates, no tensor an op creates holds more elements than one
chunk."""
import functools
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.corpus.synth import synth_corpus
from document_search_engine_tpu.index import builder as ref_builder
from document_search_engine_tpu_torch import DistributedSearchEngine, make_mesh
from document_search_engine_tpu_torch.config import IndexConfig as PortConfig
from document_search_engine_tpu_torch.config import (
    ScoringConfig as PortScoring,
)
from document_search_engine_tpu_torch.index import builder as port_builder
from document_search_engine_tpu_torch.parallel import dist as port_dist

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

F32 = np.float32
LANES = port_builder.LANES


# ------------------------------------------- the whole-plane bodies, kept
def whole_materialize(post_doc, post_tf, k_doc, inv_norm, alive, k1p1,
                      kind):
    tff = post_tf.to(torch.float32)
    pd = post_doc.long()
    if kind == "tfidf":
        val = tff * inv_norm[pd]
    else:
        val = port_builder.exact_div(tff * k1p1, tff + k_doc[pd])
    val = torch.where(alive[pd], val, torch.zeros_like(val))
    return val.view(torch.int32)


def whole_pack(rows, docs, tfs, n_terms, n_docs):
    key = (rows.to(torch.int64) << 32) | docs.to(torch.int64)
    key_s, order = torch.sort(key, stable=True)
    r64 = key_s >> 32
    r = r64.to(torch.int32)
    d = (key_s & 0xFFFFFFFF).to(torch.int32)
    t = tfs[order]
    indptr = torch.searchsorted(
        r64, torch.arange(n_terms + 1, dtype=torch.int64)
    ).to(torch.int32)
    df = torch.bincount(r[r < n_terms].long(), minlength=n_terms)[:n_terms]
    live_d = d < n_docs
    dl = torch.zeros(n_docs, dtype=torch.int32).index_add_(
        0, d[live_d].long(), t[live_d]
    )
    return r, d, t, indptr, df.to(torch.int32), dl


def whole_spmd_step(triples, indptr_g, row_start_g, k_doc, inv_norm, alive,
                    k1p1, x_rows, t_pad, d_pad, kind, mesh_):
    total = x_rows * LANES
    pds, pts, pvs, dfs = [], [], [], []
    for i, (r, d, t) in enumerate(triples):
        ip, rs = indptr_g[i], row_start_g[i]
        key = (r.to(torch.int64) << 32) | d.to(torch.int64)
        key_s, order = torch.sort(key, stable=True)
        r_s = (key_s >> 32).to(torch.int32)
        d_s = (key_s & 0xFFFFFFFF).to(torch.int32)
        t_s = t[order]
        ii = torch.arange(r_s.shape[0], dtype=torch.int64)
        rl = r_s.long()
        pos = rs[rl].long() + (ii - ip[rl].long())
        doc2 = torch.full((total,), d_pad - 1, dtype=torch.int32)
        tf2 = torch.zeros(total, dtype=torch.int32)
        doc2[pos] = d_s
        tf2[pos] = t_s
        dfs.append(torch.bincount(rl, minlength=t_pad).to(torch.int32))
        doc2 = doc2.reshape(x_rows, LANES)
        tf2 = tf2.reshape(x_rows, LANES)
        pds.append(doc2)
        pts.append(tf2)
        pvs.append(whole_materialize(
            doc2, tf2, k_doc[i], inv_norm[i], alive[i],
            torch.tensor(F32(k1p1)), kind))
    return pds, pts, pvs, port_dist.psum(dfs, mesh_.dst)


# ------------------------------------------------------------- inputs
def plane_inputs(rng, x_rows, n_docs, d_pad):
    """Doc/tf planes with sentinel padding (doc n_docs, tf 0) in about a
    third of the slots, and per-doc K, inv-norms and alive flags with
    dead docs."""
    doc = rng.integers(0, n_docs, (x_rows, LANES)).astype(np.int32)
    tf = rng.integers(1, 9, (x_rows, LANES)).astype(np.int32)
    pad = rng.random((x_rows, LANES)) < 0.3
    doc[pad], tf[pad] = n_docs, 0
    k_doc = np.zeros(d_pad, F32)
    k_doc[:n_docs] = (F32(0.54) + F32(0.0102)
                      * rng.integers(1, 3000, n_docs).astype(F32))
    inv = np.zeros(d_pad, F32)
    inv[:n_docs] = rng.random(n_docs).astype(F32) * F32(0.2) + F32(0.02)
    alive = np.zeros(d_pad, bool)
    alive[:n_docs] = rng.random(n_docs) > 0.2
    return [torch.from_numpy(a) for a in (doc, tf, k_doc, inv, alive)]


def unique_triples(rng, n_terms, n_docs, nnz, pad):
    """Shuffled triples with unique (row, doc) pairs, then `pad` sentinel
    triples (n_terms, n_docs, 0), as the bucketed build uploads them."""
    key = np.unique(rng.integers(0, n_terms * n_docs, nnz))
    rows = (key // n_docs).astype(np.int32)
    docs = (key % n_docs).astype(np.int32)
    perm = rng.permutation(len(rows))
    rows, docs = rows[perm], docs[perm]
    tfs = rng.integers(1, 5, len(rows)).astype(np.int32)
    return (np.concatenate([rows, np.full(pad, n_terms, np.int32)]),
            np.concatenate([docs, np.full(pad, n_docs, np.int32)]),
            np.concatenate([tfs, np.zeros(pad, np.int32)]))


def repeated_triples(rng, n_terms, n_docs, nnz):
    """Unsorted triples whose (row, doc) pairs repeat, as the bench's
    draw gives them, with distinct tfs so that the order of the
    repeats shows."""
    rows = rng.integers(0, n_terms, nnz).astype(np.int32)
    docs = rng.integers(0, n_docs, nnz).astype(np.int32)
    tfs = rng.permutation(nnz).astype(np.int32) + 1
    return rows, docs, tfs


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------ materialization
@pytest.mark.parametrize("x_rows", [1, 37])
@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_materialize_chunks_equal_whole_plane(kind, x_rows):
    """Every block size, from one row to more than the plane, gives the
    whole-plane body's bits: dead docs and sentinel padding at +0.0
    (bm25 computes 0/0 there)."""
    rng = np.random.default_rng(31 + x_rows)
    n_docs = 300
    doc, tf, k_doc, inv, alive = plane_inputs(rng, x_rows, n_docs, 384)
    k1p1 = torch.tensor(F32(1.9))
    want = whole_materialize(doc, tf, k_doc, inv, alive, k1p1, kind)
    pad_bits = want[doc == n_docs]
    assert pad_bits.numel() and (pad_bits == 0).all()
    for block in sorted({1, 3, max(x_rows - 1, 1), x_rows, x_rows + 5}):
        got = port_builder.device_materialize_vals(
            doc, tf, k_doc, inv, alive, k1p1, kind=kind, block_rows=block)
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert torch.equal(got, want), (kind, x_rows, block)


# ---------------------------------------------------------------- pack
@pytest.mark.parametrize("chunk", [1, 7, None])
def test_pack_chunks_equal_jax_on_unique_pairs(chunk):
    """Unique pairs with sentinel padding: all six outputs equal the JAX
    device_pack's at C = 1, 7 and nnz postings."""
    rng = np.random.default_rng(5)
    n_terms, n_docs = 41, 60
    rows, docs, tfs = unique_triples(rng, n_terms, n_docs, 700, pad=45)
    want = ref_builder.device_pack(
        jnp.asarray(rows), jnp.asarray(docs), jnp.asarray(tfs),
        n_terms=n_terms, n_docs=n_docs,
    )
    got = port_builder.device_pack(
        *_t(rows, docs, tfs), n_terms=n_terms, n_docs=n_docs,
        chunk=chunk or len(rows),
    )
    for name, g, w in zip(("r", "d", "t", "indptr", "df", "dl"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)


@pytest.mark.parametrize("chunk", [1, 7, 64, None])
def test_pack_chunks_keep_stable_order_of_repeated_pairs(chunk):
    """Unsorted input with repeated (row, doc) pairs, sentinel rows and
    docs among them: the outputs equal one stable sort of the int64 key
    (the reference's lax.sort is not stable, so JAX has no counterpart
    here)."""
    rng = np.random.default_rng(7)
    n_terms, n_docs = 23, 17
    rows, docs, tfs = repeated_triples(rng, n_terms + 1, n_docs + 1, 900)
    args = _t(rows, docs, tfs)
    want = whole_pack(*args, n_terms=n_terms, n_docs=n_docs)
    got = port_builder.device_pack(*args, n_terms=n_terms, n_docs=n_docs,
                                   chunk=chunk or len(rows))
    for name, g, w in zip(("r", "d", "t", "indptr", "df", "dl"), got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), (name, chunk)


def test_pack_of_nothing():
    empty = torch.zeros(0, dtype=torch.int32)
    r, d, t, indptr, df, dl = port_builder.device_pack(
        empty, empty, empty, n_terms=5, n_docs=3, chunk=4)
    assert r.numel() == d.numel() == t.numel() == 0
    assert (indptr == 0).all() and indptr.numel() == 6
    assert (df == 0).all() and (dl == 0).all() and dl.numel() == 3


# --------------------------------------------------------------- align
@pytest.mark.parametrize("chunk", [1, 7, None])
def test_align_chunks_equal_jax(chunk):
    """The bucketed build's inputs (sentinel rows t_cap, row_start padded
    with one past the plane): the doc/tf planes equal the JAX
    device_align_planes' at C = 1, 7 and nnz postings."""
    rng = np.random.default_rng(9)
    n_terms, n_docs, t_cap = 37, 80, 48
    rows, docs, tfs = unique_triples(rng, n_terms, n_docs, 900, pad=0)
    nnz_cap = len(rows) + 40
    rows = port_builder._pad(rows, nnz_cap, t_cap, np.int32)
    docs = port_builder._pad(docs, nnz_cap, n_docs + 3, np.int32)
    tfs = port_builder._pad(tfs, nnz_cap, 0, np.int32)
    r, d, t, indptr_d, _df, _dl = port_builder.device_pack(
        *_t(rows, docs, tfs), n_terms=t_cap, n_docs=n_docs + 3)
    indptr = indptr_d[: n_terms + 1].numpy()
    row_start, x_rows = port_builder.aligned_geometry(indptr, 128)
    x_cap = port_builder.shape_bucket(x_rows)
    rs = port_builder._pad(row_start, t_cap, x_cap * LANES,
                           np.int64).astype(np.int32)
    want = ref_builder.device_align_planes(
        jnp.asarray(r.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(t.numpy()), jnp.asarray(indptr_d.numpy()),
        jnp.asarray(rs), x_rows=x_cap, n_docs=n_docs,
    )
    got = port_builder.device_align_planes(
        r, d, t, indptr_d, torch.from_numpy(rs), x_rows=x_cap,
        n_docs=n_docs, chunk=chunk or nnz_cap,
    )
    for name, g, w in zip(("doc", "tf"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)


# -------------------------------------- the build paths, forced to chunk
def small_chunks(monkeypatch, pack_chunk, block_rows):
    for name, kw in (("device_pack", {"chunk": pack_chunk}),
                     ("device_align_planes", {"chunk": pack_chunk}),
                     ("device_materialize_vals",
                      {"block_rows": block_rows})):
        monkeypatch.setattr(port_builder, name, functools.partial(
            getattr(port_builder, name), **kw))


@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_build_segment_device_in_chunks_matches_jax(kind, monkeypatch):
    """build_segment_device with every stage cut into many chunks: doc,
    tf, indptr and row_start planes equal the JAX device build's, and
    the values the whole-plane body over the same planes."""
    small_chunks(monkeypatch, pack_chunk=97, block_rows=3)
    docs = synth_corpus(n_docs=120, vocab_size=500, mean_len=30, seed=27)
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    pcfg = PortConfig(scoring=PortScoring(kind=kind))
    a = ref_builder.analyze_texts_fast(docs, cfg)
    _rh, rd = ref_builder.build_segment_device(a, cfg, doc_base=3)
    ph, pd = port_builder.build_segment_device(a, pcfg, "cpu", doc_base=3)
    for f in ("post_doc", "post_tf", "indptr", "row_start"):
        np.testing.assert_array_equal(getattr(pd, f).numpy(),
                                      np.asarray(getattr(rd, f)), f)
    want = whole_materialize(
        pd.post_doc, pd.post_tf,
        torch.from_numpy(port_builder._pad(port_builder.host_k_doc(
            ph.dl, pcfg, port_builder.GlobalStats(
                vocab=ph.term_hash, df=ph.df, n_alive=ph.n_docs,
                total_len_alive=int(ph.dl.sum()))),
            pd.n_docs_pad, 0, np.float32)),
        pd.inv_norm, pd.alive, torch.tensor(F32(pcfg.scoring.k1 + 1.0)),
        kind)
    assert torch.equal(pd.post_val, want)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_spmd_build_step_equals_whole_body(n_shards, monkeypatch):
    """The sharded build's step, through the shared chunked functions at
    small chunks, gives the planes and the psum'd df of its former
    inline body, shard by shard, on the inputs the engine's build
    hands it."""
    small_chunks(monkeypatch, pack_chunk=53, block_rows=2)
    step = port_dist._spmd_build_step
    seen = []

    def both(triples, *args, **kw):
        triples = list(triples)
        want = whole_spmd_step(triples, *args, **kw)
        got = step(iter(triples), *args, **kw)
        seen.append((got, want))
        return got

    monkeypatch.setattr(port_dist, "_spmd_build_step", both)
    docs = synth_corpus(n_docs=90, vocab_size=600, mean_len=35, seed=11)
    for kind in ("bm25", "tfidf"):
        eng = DistributedSearchEngine(
            PortConfig(scoring=PortScoring(kind=kind)),
            mesh=make_mesh(n_shards, device="cpu"))
        eng.build(docs)
    assert len(seen) == 2
    for got, want in seen:
        for name, g, w in zip(("doc", "tf", "val"), got[:3], want[:3]):
            assert len(g) == len(w) == n_shards
            for i, (gi, wi) in enumerate(zip(g, w)):
                assert torch.equal(gi, wi), (name, i)
        assert torch.equal(got[3], want[3])


def test_spmd_build_step_frees_each_shards_triples(monkeypatch):
    """The sharded build uploads a shard's triples only when the step
    takes them, and frees them once packed: when a shard's planes are
    aligned, nothing holds its uploaded triples any more."""
    uploaded, freed_at_align = [], []
    align = port_builder.device_align_planes

    def watched_align(*a, **kw):
        freed_at_align.append(all(ref() is None for ref in uploaded[-1]))
        return align(*a, **kw)

    class Watched:
        """The triples' iterator, recording each shard's as it is taken
        (and holding none of them)."""

        def __init__(self, it):
            self.it = it

        def __next__(self):
            tr = next(self.it)
            uploaded.append([weakref.ref(x) for x in tr])
            return tr

    step = port_dist._spmd_build_step
    monkeypatch.setattr(port_builder, "device_align_planes", watched_align)
    monkeypatch.setattr(port_dist, "_spmd_build_step",
                        lambda triples, *a, **kw: step(Watched(triples),
                                                       *a, **kw))
    docs = synth_corpus(n_docs=60, vocab_size=300, mean_len=20, seed=17)
    eng = DistributedSearchEngine(
        PortConfig(scoring=PortScoring(kind="bm25")),
        mesh=make_mesh(3, device="cpu"))
    eng.build(docs)
    assert freed_at_align == [True, True, True]


# -------------------------------------------------------- memory bound
class NewTensors(TorchDispatchMode):
    """Records every tensor an op creates on storage none of its inputs
    share (views and in-place results are not new), holding each so that
    no address is reused while recording."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {a.untyped_storage().data_ptr()
                for a in tree_flatten((args, kwargs))[0]
                if isinstance(a, torch.Tensor)}
        for o in tree_flatten(out)[0]:
            if (isinstance(o, torch.Tensor) and o.numel()
                    and o.untyped_storage().data_ptr() not in seen):
                self.made.append((str(func), o))
        return out


def temporaries(fn, outputs_of):
    """Run fn under NewTensors; return (sizes of the tensors it created
    that are not on the returned outputs' storage, numel of those that
    are)."""
    with NewTensors() as rec:
        out = fn()
    keep = {o.untyped_storage().data_ptr() for o in outputs_of(out)}
    temps = [(name, t.numel()) for name, t in rec.made
             if t.untyped_storage().data_ptr() not in keep]
    outs = [t.numel() for _n, t in rec.made
            if t.untyped_storage().data_ptr() in keep]
    return temps, outs


def test_stages_hold_no_temporary_beyond_a_chunk():
    """On inputs of 64 chunks, each stage's temporaries are at most one
    chunk long: device_pack's beyond its r/d/t outputs (the per-row and
    per-doc counts are shorter than a chunk here), device_align_planes'
    beyond its two planes, device_materialize_vals' beyond its value
    plane."""
    rng = np.random.default_rng(13)
    chunk, n_terms, n_docs, nnz = 256, 200, 100, 64 * 256
    rows, docs, tfs = repeated_triples(rng, n_terms, n_docs, nnz - 60)
    rows = np.concatenate([rows, np.full(60, n_terms, np.int32)])
    docs = np.concatenate([docs, np.full(60, n_docs, np.int32)])
    tfs = np.concatenate([tfs, np.zeros(60, np.int32)])
    assert np.bincount(rows).max() <= chunk  # no row longer than a chunk
    args = _t(rows, docs, tfs)

    temps, outs = temporaries(
        lambda: port_builder.device_pack(*args, n_terms=n_terms,
                                         n_docs=n_docs, chunk=chunk),
        lambda out: out[:3])
    assert sorted(outs) == [nnz] * 3
    assert max(n for _f, n in temps) <= chunk, max(temps, key=lambda x: x[1])
    r, d, t, indptr, _df, _dl = port_builder.device_pack(
        *args, n_terms=n_terms, n_docs=n_docs, chunk=chunk)

    row_start, x_rows = port_builder.aligned_geometry(indptr.numpy(), 128)
    rs = torch.from_numpy(row_start.astype(np.int32))
    temps, outs = temporaries(
        lambda: port_builder.device_align_planes(
            r, d, t, indptr, rs, x_rows=x_rows, n_docs=n_docs, chunk=chunk),
        lambda out: out)
    assert sorted(outs) == [x_rows * LANES] * 2
    assert max(n for _f, n in temps) <= chunk, max(temps, key=lambda x: x[1])

    block_rows = 2
    x = 64 * block_rows
    doc, tf, k_doc, inv, alive = plane_inputs(rng, x, n_docs, 128)
    for kind in ("bm25", "tfidf"):
        temps, outs = temporaries(
            lambda: port_builder.device_materialize_vals(
                doc, tf, k_doc, inv, alive, torch.tensor(F32(1.9)),
                kind=kind, block_rows=block_rows),
            lambda out: [out])
        assert outs == [x * LANES]
        assert max(n for _f, n in temps) <= block_rows * LANES, kind
