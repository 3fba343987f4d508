"""The torch port's index lifecycle (CPU) against the frozen oracle, a
fresh rebuild and the JAX package: the streaming build, add_docs past
the auto-compact bound, delete_docs, compact and the auto-compact
policy. Ids and int32 scores must be bit-identical, and so must the
doc/tf plane bits where stated; deleted ids never come back; after a
mutation every scorer still serves and no device cache keeps a plane
that is not a live segment's. Also: delete_from_hosts against the
per-doc loop it replaced, and the host work of a 200k-doc delete and
compact (device work stubbed). Each package's engine is configured with
its own package's IndexConfig."""
import copy
import time

import numpy as np
import pytest
import torch

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.corpus.synth import synth_corpus, synth_queries
from document_search_engine_tpu.engine.engine import (
    SearchEngine as RefEngine,
)
from document_search_engine_tpu_torch import SearchEngine
from document_search_engine_tpu_torch import config as port_config
from document_search_engine_tpu_torch.corpus.loader import stream_batches
from document_search_engine_tpu_torch.engine import engine as port_engine
from document_search_engine_tpu_torch.index import builder as port_builder
from document_search_engine_tpu_torch.index.csr import SegmentHost
from document_search_engine_tpu_torch.oracle import OracleEngine

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

KINDS = ["tfidf", "bm25"]


def _cfg(kind):
    return IndexConfig(scoring=ScoringConfig(kind=kind))


def _port_cfg(kind):
    return port_config.IndexConfig(
        scoring=port_config.ScoringConfig(kind=kind)
    )


def _port(kind, scorer=None):
    eng = SearchEngine(_port_cfg(kind), device="cpu")
    eng.scorer = scorer
    return eng


def _assert_same(got, want, what):
    np.testing.assert_array_equal(got[0], want[0], f"{what} ids")
    np.testing.assert_array_equal(got[1], want[1], f"{what} scores")


def _assert_caches_live(eng):
    """No _dv_cache / _quant_cache entry holds a plane that is not the
    current plane of a live segment."""
    for si, ent in eng._dv_cache.items():
        dev = eng.segments[si][1]
        assert ent[0] is dev.post_doc and ent[1] is dev.post_val, si
    for si, ent in eng._quant_cache.items():
        assert ent[0] is eng.segments[si][1].post_doc, si


# ------------------------------------------------------- streaming build
@pytest.mark.parametrize("kind", KINDS)
def test_build_streaming_equals_bulk(kind):
    """Five batches of 16: the default policy (4 segments) compacts them
    into one, and with the policy off the five segments serve alike;
    both equal the bulk build, the oracle and the JAX package's
    streaming build on the same batches."""
    docs = synth_corpus(n_docs=70, vocab_size=300, mean_len=25, seed=8)
    queries = synth_queries(docs, n_queries=5, seed=9)
    bulk = _port(kind)
    bulk.build(docs)
    want = bulk.search(queries, k=10)
    ora = OracleEngine(_port_cfg(kind))
    ora.build(docs)
    _assert_same(want, ora.search(queries, k=10), f"{kind} bulk")
    ref = RefEngine(_cfg(kind))
    ref.build_streaming(stream_batches(docs, batch_size=16))
    _assert_same(ref.search(queries, k=10), want, f"{kind} JAX streaming")
    stream = _port(kind)
    stream.build_streaming(stream_batches(docs, batch_size=16))
    assert len(stream.segments) == 1 == len(ref.segments)
    _assert_same(stream.search(queries, k=10), want, f"{kind} streaming")
    # the compacted planes are the bulk build's
    for f in ("post_doc", "post_tf", "post_val", "indptr", "row_start"):
        assert torch.equal(getattr(stream.segments[0][1], f),
                           getattr(bulk.segments[0][1], f)), f
    frag = _port(kind)
    frag.auto_compact_segments = None
    # an empty batch builds no segment
    frag.build_streaming([[]] + list(stream_batches(docs, batch_size=16)))
    assert len(frag.segments) == 5
    assert [h.doc_base for h, _ in frag.segments] == [0, 16, 32, 48, 64]
    _assert_same(frag.search(queries, k=10), want, f"{kind} five segments")


# ------------------------------------------------------------- compact
@pytest.mark.parametrize("kind", KINDS)
def test_compact_preserves_results(kind):
    docs = synth_corpus(n_docs=50, vocab_size=400, mean_len=30, seed=5)
    queries = synth_queries(docs, n_queries=6, seed=6)
    eng = _port(kind)
    eng.build(docs)
    eng.add_docs(docs[:10])  # second segment
    eng.delete_docs([0, 3, 55])
    want = eng.search(queries, k=10)
    ora = OracleEngine(_port_cfg(kind))
    ora.build(docs)
    ora.add_docs(docs[:10])
    ora.delete_docs([0, 3, 55])
    _assert_same(want, ora.search(queries, k=10), f"{kind} before compact")
    assert len(eng.segments) == 2
    eng.compact()
    assert len(eng.segments) == 1 and eng.n_docs_total == 60
    got = eng.search(queries, k=10)
    _assert_same(got, want, f"{kind} after compact")
    # deleted ids never come back, and keep empty slots
    assert not set(got[0].ravel().tolist()) & {0, 3, 55}
    host = eng.segments[0][0]
    assert not host.alive[[0, 3, 55]].any() and (host.dl[[0, 3, 55]] == 0).all()


# ---------------------------------------------------------------- fuzz
@pytest.mark.parametrize("scorer", ["plain", "fused"])
def test_segment_lifecycle_bounded_fuzz(scorer):
    """A long add/delete sequence keeps the segment count bounded by
    auto-compact, and the incrementally kept index stays bit-identical
    to a fresh rebuild with the same deletes and to the oracle with the
    same history."""
    rng = np.random.default_rng(33)
    pool = synth_corpus(n_docs=120, vocab_size=500, mean_len=25, seed=34)
    queries = synth_queries(pool, n_queries=5, seed=35)
    eng = _port("bm25", scorer)
    eng.auto_compact_segments = 4
    eng.auto_compact_dead_frac = 0.4
    ora = OracleEngine(_port_cfg("bm25"))
    eng.build(pool[:20])
    ora.build(pool[:20])
    texts = list(pool[:20])  # mirror of the corpus by global id
    alive = [True] * 20
    max_segments_seen, compactions = 1, 0
    for step in range(60):
        n_before = len(eng.segments)
        if rng.random() < 0.5:
            new = [pool[int(i)] for i in rng.integers(0, 120, 3)]
            ids = eng.add_docs(new)
            assert ora.add_docs(new) == ids
            texts += new
            alive += [True] * len(new)
            assert ids == list(range(len(texts) - 3, len(texts)))
        else:
            live = [g for g, a in enumerate(alive) if a]
            if live:
                kill = [int(g) for g in rng.choice(
                    live, size=min(4, len(live)), replace=False)]
                eng.delete_docs(kill)
                ora.delete_docs(kill)
                for g in kill:
                    alive[g] = False
        compactions += len(eng.segments) < n_before
        max_segments_seen = max(max_segments_seen, len(eng.segments))
        assert len(eng.segments) <= 5  # policy bound (4 + in-flight add)
        if step % 15 == 14:
            _assert_same(eng.search(queries, k=10),
                         ora.search(queries, k=10), f"step {step}")
    assert max_segments_seen >= 2 and compactions >= 1
    fresh = _port("bm25", scorer)
    fresh.build(texts)
    fresh.delete_docs([g for g, a in enumerate(alive) if not a])
    want = fresh.search(queries, k=10)
    _assert_same(eng.search(queries, k=10), want, "fuzz vs fresh rebuild")
    _assert_same(ora.search(queries, k=10), want, "oracle vs fresh rebuild")


# ------------------------------------------- every scorer after a mutation
@pytest.mark.parametrize("mutation", ["delete", "compact", "add"])
def test_every_scorer_serves_after_mutation(mutation):
    """After a mutation, scorers fused, fused_dv, xla_rank and fused
    with split_rows 2 each equal the oracle, and the dv and quantile
    caches filled before the mutation hold no plane of a replaced
    segment."""
    docs = synth_corpus(n_docs=60, vocab_size=300, mean_len=25, seed=41)
    queries = synth_queries(docs, n_queries=8, seed=42)
    eng = _port("bm25")
    eng.build(docs[:40])
    eng.add_docs(docs[40:])
    ora = OracleEngine(_port_cfg("bm25"))
    ora.build(docs[:40])
    ora.add_docs(docs[40:])
    modes = (("fused", None), ("fused_dv", None), ("xla_rank", None),
             ("fused", 2))
    for scorer, split in modes:  # fill both caches
        eng.scorer, eng.split_rows = scorer, split
        eng.search(queries, k=10)
    assert eng._dv_cache and eng._quant_cache
    if mutation == "delete":
        eng.delete_docs([1, 2, 44])
        ora.delete_docs([1, 2, 44])
    elif mutation == "compact":
        eng.delete_docs([5])
        ora.delete_docs([5])
        eng.compact()
        assert len(eng.segments) == 1
    else:
        eng.add_docs(docs[:7])
        ora.add_docs(docs[:7])
    assert not eng._dv_cache and not eng._quant_cache
    want = ora.search(queries, k=10)
    for scorer, split in modes:
        eng.scorer, eng.split_rows = scorer, split
        _assert_same(eng.search(queries, k=10), want,
                     f"{mutation} {scorer} split_rows={split}")
        _assert_caches_live(eng)
    assert eng._dv_cache and eng._quant_cache


# ------------------------------------------- the history against JAX
def _planes_equal(port_seg, ref_seg, what):
    ph, pd = port_seg
    rh, rd = ref_seg
    for f in ("post_doc", "post_tf", "alive", "indptr", "row_start"):
        np.testing.assert_array_equal(
            getattr(pd, f).numpy(), np.asarray(getattr(rd, f)),
            f"{what} {f}")
    for f in ("alive", "dl", "df", "term_hash"):
        np.testing.assert_array_equal(getattr(ph, f), getattr(rh, f),
                                      f"{what} host {f}")


@pytest.mark.parametrize("kind", KINDS)
def test_lifecycle_matches_jax_package(kind):
    """One history through the port (CPU, plain scorer) and the JAX
    engine (CPU, xla scorer): a build, four add_docs that cross the
    auto-compact bound, a delete and a compact, compared after every
    step; the doc/tf planes and alive flags after each compaction."""
    docs = synth_corpus(n_docs=70, vocab_size=400, mean_len=25, seed=51)
    queries = synth_queries(docs, n_queries=8, seed=52)
    port = _port(kind, "plain")
    ref = RefEngine(_cfg(kind))
    ref.scorer = "xla"
    steps = [("build", docs[:30])]
    steps += [("add", docs[lo : lo + 10]) for lo in (30, 40, 50, 60)]
    steps += [("delete", [2, 31, 45, 69, 500]), ("compact", None)]
    for op, arg in steps:
        for eng in (port, ref):
            if op == "build":
                eng.build(arg)
            elif op == "add":
                eng.add_docs(arg)
            elif op == "delete":
                eng.delete_docs(arg)
            else:
                eng.compact()
        assert len(port.segments) == len(ref.segments), op
        assert port.n_docs_total == ref.n_docs_total, op
        for k in (1, 10):
            _assert_same(port.search(queries, k=k), ref.search(queries, k=k),
                         f"{kind} after {op} k={k}")
        if len(port.segments) == 1 and op != "build":
            _planes_equal(port.segments[0], ref.segments[0], f"{kind} {op}")
    assert len(port.segments) == 1
    assert not set(port.search(queries, k=10)[0].ravel()) & {2, 31, 45, 69}


# ------------------------------------------------- host work at scale
def _synth_host(n_docs, tpd, vocab, seed=0, doc_base=0):
    """A SegmentHost made directly with numpy (no text work): each doc
    gets `tpd` distinct ascending term hashes, one per vocab stratum."""
    rng = np.random.default_rng(seed)
    vocab_h = np.unique(
        rng.integers(1, 2**63, vocab * 2, dtype=np.uint64)
    )[:vocab]
    stride = vocab // tpd
    idx = rng.integers(0, stride, (n_docs, tpd)) + np.arange(tpd) * stride
    hashes = vocab_h[idx].ravel()
    tfs = rng.integers(1, 4, n_docs * tpd).astype(np.int32)
    term_hash, rows = np.unique(hashes, return_inverse=True)
    return SegmentHost(
        term_hash=term_hash,
        df=np.bincount(rows, minlength=len(term_hash)).astype(np.int32),
        doc_base=doc_base,
        n_docs=n_docs,
        dl=tfs.reshape(n_docs, tpd).sum(1).astype(np.int32),
        alive=np.ones(n_docs, bool),
        doc_hashes=hashes,
        doc_tfs=tfs,
        doc_ptr=np.arange(n_docs + 1, dtype=np.int64) * tpd,
    )


def _recounted_df(host):
    h = copy.deepcopy(host)
    port_builder.recompute_alive_df(h)
    return h.df


def test_delete_from_hosts_matches_per_doc_loop():
    """delete_from_hosts == the per-doc loop it replaced, with
    duplicates, already-dead ids and out-of-range ids."""
    hosts = [_synth_host(40, 4, 80, seed=1, doc_base=0),
             _synth_host(25, 4, 60, seed=2, doc_base=40)]
    ref = copy.deepcopy(hosts)
    gids = [0, 0, 3, 39, 40, 41, 64, 64, -5, 65, 200, 7]

    def ref_delete(hosts_, gids_):
        changed = False
        for g in gids_:
            for host in hosts_:
                if host.doc_base <= g < host.doc_base + host.n_docs:
                    ld = g - host.doc_base
                    if host.alive[ld]:
                        host.alive[ld] = False
                        s, e = host.doc_ptr[ld], host.doc_ptr[ld + 1]
                        rows = np.searchsorted(
                            host.term_hash, host.doc_hashes[s:e]
                        )
                        host.df[rows] -= 1
                        changed = True
                    break
        return changed

    # the second round deletes only already-dead and out-of-range ids
    for round_gids in (gids, [0, 3, -1, 999]):
        got = port_engine.delete_from_hosts(hosts, round_gids)
        assert got == ref_delete(ref, round_gids)
        for h_new, h_ref in zip(hosts, ref):
            np.testing.assert_array_equal(h_new.alive, h_ref.alive)
            np.testing.assert_array_equal(h_new.df, h_ref.df)
            np.testing.assert_array_equal(h_new.df, _recounted_df(h_new))
    assert not port_engine.delete_from_hosts(hosts, [])
    assert not port_engine.delete_from_hosts([], [1])
    with pytest.raises(AssertionError, match="contiguous"):
        port_engine.delete_from_hosts(hosts[::-1], [1])


def test_delete_docs_host_work_is_vectorized_at_scale():
    """Deleting 50k docs from a 200k-doc two-segment engine is
    vectorized host work (< 2 s), with one refresh; df equals the recount
    over alive docs (builder.recompute_alive_df). The device refresh is
    stubbed: it is O(index) by design and not this path."""
    eng = SearchEngine(device="cpu")
    h0 = _synth_host(150_000, 8, 20_000, seed=3, doc_base=0)
    h1 = _synth_host(50_000, 8, 20_000, seed=4, doc_base=150_000)
    eng.segments = [[h0, None], [h1, None]]
    eng.n_docs_total = 200_000
    calls = []
    eng._refresh_stats_and_vals = lambda: calls.append(1)
    eng._maybe_auto_compact = lambda: None
    gids = np.random.default_rng(9).choice(200_000, size=50_000,
                                           replace=False)
    t0 = time.perf_counter()
    eng.delete_docs(gids)
    dt = time.perf_counter() - t0
    assert calls == [1]  # exactly one refresh
    assert dt < 2.0, f"vectorized delete took {dt:.2f}s"
    assert h0.n_alive + h1.n_alive == 150_000
    for h in (h0, h1):
        np.testing.assert_array_equal(h.df, _recounted_df(h))


def _compact_capture(eng, monkeypatch):
    """eng.compact() with the device build and refresh stubbed: returns
    the merged AnalyzedDocs, the dead mask and the doc_base the
    vectorized assembly produced."""
    captured = {}

    def fake_build(analyzed, config, device, doc_base):
        captured["a"], captured["base"] = analyzed, doc_base
        host = SegmentHost(np.zeros(0, np.uint64), np.zeros(0, np.int32),
                           doc_base, analyzed.n_docs, analyzed.dl,
                           np.ones(analyzed.n_docs, bool))
        return host, None

    monkeypatch.setattr(port_builder, "build_segment_device", fake_build)
    eng._refresh_stats_and_vals = lambda: None
    eng.compact()
    return captured["a"], ~eng.segments[0][0].alive, captured["base"]


def test_compact_assembly_matches_per_doc_loop(monkeypatch):
    """The vectorized compact assembly == the per-doc loop, with dead
    docs in both segments, a dead prefix and interleaved tombstones."""
    eng = SearchEngine(device="cpu")
    h0 = _synth_host(300, 5, 900, seed=11, doc_base=0)
    h1 = _synth_host(180, 5, 900, seed=12, doc_base=300)
    rng = np.random.default_rng(13)
    h0.alive[:7] = False  # dead prefix
    h0.alive[rng.choice(300, 60, replace=False)] = False
    h1.alive[rng.choice(180, 40, replace=False)] = False
    eng.segments = [[h0, None], [h1, None]]
    eng.n_docs_total = 480
    n = 480
    hp, tp = [], []
    ptr = np.zeros(n + 1, np.int64)
    dl = np.zeros(n, np.int32)
    dead = np.zeros(n, bool)
    for host in (h0, h1):
        for ld in range(host.n_docs):
            g = host.doc_base + ld
            if host.alive[ld]:
                s, e = host.doc_ptr[ld], host.doc_ptr[ld + 1]
                hp.append(host.doc_hashes[s:e])
                tp.append(host.doc_tfs[s:e])
                ptr[g + 1] = e - s
                dl[g] = host.dl[ld]
            else:
                dead[g] = True
    np.cumsum(ptr, out=ptr)
    a, got_dead, base = _compact_capture(eng, monkeypatch)
    assert base == 0
    np.testing.assert_array_equal(a.hashes, np.concatenate(hp))
    np.testing.assert_array_equal(a.tfs, np.concatenate(tp))
    np.testing.assert_array_equal(a.doc_ptr, ptr)
    np.testing.assert_array_equal(a.dl, dl)
    np.testing.assert_array_equal(got_dead, dead)


def test_compact_host_work_is_vectorized_at_scale(monkeypatch):
    """Compacting a 200k-doc two-segment engine with 60k tombstones
    assembles the merged postings in vectorized host work (< 2 s); the
    device build and refresh are stubbed."""
    eng = SearchEngine(device="cpu")
    h0 = _synth_host(150_000, 8, 20_000, seed=14, doc_base=0)
    h1 = _synth_host(50_000, 8, 20_000, seed=15, doc_base=150_000)
    gids = np.random.default_rng(16).choice(200_000, size=60_000,
                                            replace=False)
    h0.alive[gids[gids < 150_000]] = False
    h1.alive[gids[gids >= 150_000] - 150_000] = False
    eng.segments = [[h0, None], [h1, None]]
    eng.n_docs_total = 200_000
    t0 = time.perf_counter()
    a, got_dead, _ = _compact_capture(eng, monkeypatch)
    dt = time.perf_counter() - t0
    assert dt < 2.0, f"vectorized compact assembly took {dt:.2f}s"
    assert a.n_docs == 200_000 and int(got_dead.sum()) == 60_000
    want_nnz = 8 * (200_000 - 60_000)  # 8 terms per synthetic doc
    assert len(a.hashes) == want_nnz and int(a.doc_ptr[-1]) == want_nnz
