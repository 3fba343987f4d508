"""The torch port's benchmark (document_search_engine_tpu_torch/bench.py)
against the repo-root bench.py and the JAX engine, on the CPU at small
sizes: the host generators equal bench.py's; the plane fill equals a
numpy-f32 transcription of bench.py's formula across chunk edges; the
engine built on bench.py's own doc/tf planes has bench.py's vocabulary,
geometry, doc stats and resident bytes, and its value plane equals the
JAX build's bits (or, where those are off the spec, oracle/spec.py's);
with the JAX value plane loaded it serves the JAX engine's ids and int32
scores; the step replay, the serving loop without analysis and the
1-shard sharded wrapper return search's results; the device pack of
drawn triples equals the host build's planes; a leg that raises fails
the run without a JSON line, and a leg not started by the deadline is
skipped with a null key."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from document_search_engine_tpu.config import IndexConfig as RefConfig
from document_search_engine_tpu.config import ScoringConfig as RefScoring
from document_search_engine_tpu_torch import bench
from document_search_engine_tpu_torch.config import (
    IndexConfig,
    ScoringConfig,
)
from document_search_engine_tpu_torch.index import builder
from document_search_engine_tpu_torch.oracle import spec

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
F32 = np.float32
N_DOCS, VOCAB, AVG_TERMS = 3000, 2000, 20
NQ = 48


def _load_reference_bench():
    """The repo-root bench.py, loaded as the JAX package's CLI loads it."""
    sp = importlib.util.spec_from_file_location(
        "dse_bench_reference", REPO / "bench.py")
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


ref_bench = _load_reference_bench()
_JAX = {}


def _cfgs(kind):
    return (RefConfig(scoring=RefScoring(kind=kind)),
            IndexConfig(scoring=ScoringConfig(kind=kind)))


def _jax_synth(kind):
    """bench.py's JAX build_synth_engine(3000, 2000, 20), once per kind."""
    if kind not in _JAX:
        _JAX[kind] = ref_bench.build_synth_engine(
            N_DOCS, VOCAB, AVG_TERMS, _cfgs(kind)[0])
    return _JAX[kind]


def _port_on_jax_planes(kind):
    """engine_from_planes over the JAX build's doc/tf planes, dl and
    inv-norms."""
    jeng, jdf, _tok = _jax_synth(kind)
    rh, rd = jeng.segments[0]
    return bench.engine_from_planes(
        torch.from_numpy(np.array(rd.post_doc)),
        torch.from_numpy(np.array(rd.post_tf)),
        rh.indptr, rh.row_start, rh.term_hash, jdf, rh.dl,
        np.asarray(rd.inv_norm)[:N_DOCS], _cfgs(kind)[1], "cpu",
    )


@pytest.mark.parametrize("what", ["zipf_df", "synth_text_batches",
                                  "make_batches"])
def test_host_generators_equal_bench_py(what):
    if what == "zipf_df":
        for args in ((N_DOCS, VOCAB, AVG_TERMS), (1000, 50_000, 60),
                     (5, 10, 3)):
            np.testing.assert_array_equal(bench.zipf_df(*args),
                                          ref_bench.zipf_df(*args))
    elif what == "synth_text_batches":
        for args, kw in (((300, 500, 10, 120), {}),
                         ((257, 2000, 40, 64), {"seed": 9})):
            got = bench.synth_text_batches(*args, **kw)
            assert got == ref_bench.synth_text_batches(*args, **kw)
            assert [len(b) for b in got][0] == args[3]
    else:
        df = bench.zipf_df(N_DOCS, VOCAB, AVG_TERMS)[
            np.random.default_rng(2).permutation(VOCAB)]
        tokens = [f"w{i:07d}" for i in range(VOCAB)]
        for tok, kw in ((tokens, {}), (np.array(tokens, dtype=object),
                                       {"seed": 23})):
            got = bench.make_batches(df, tok, NQ, 8, 3, **kw)
            want = ref_bench.make_batches(df, tok, NQ, 8, 3, **kw)
            assert got == want
            assert len(got[0]) == 3 and len(got[0][0]) == NQ


def test_plane_fill_equals_bench_py_formula():
    """fill_planes with fixed (u, tf) draws, in chunks whose edges cut
    through rows, equals a numpy-f32 transcription of bench.py's gen."""
    rng = np.random.default_rng(0)
    n_docs, vocab, gen_chunk = 500, 300, 1000
    lens = bench.zipf_df(n_docs, vocab, 20)[rng.permutation(vocab)]
    indptr = np.zeros(vocab + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    row_start, x_rows = builder.aligned_geometry(indptr, 1024)
    total = x_rows * 128
    al = np.empty(vocab + 1, np.int64)
    al[:-1], al[-1] = row_start, total
    edges = np.arange(gen_chunk, total, gen_chunk)
    straddle = ((row_start[:, None] < edges)
                & (row_start[:, None] + lens[:, None] > edges))
    assert straddle.any(), "no row straddles a chunk edge"
    u = rng.random(total, dtype=np.float32)
    tf = rng.integers(1, 5, total).astype(np.int32)

    def draw(c0, n):
        return torch.from_numpy(u[c0 : c0 + n]), torch.from_numpy(
            tf[c0 : c0 + n])

    doc2, tf2 = bench.fill_planes(
        torch.from_numpy(al.astype(np.int32)),
        torch.from_numpy(lens.astype(np.int32)), n_docs, x_rows, draw,
        gen_chunk)
    # bench.py's gen, in numpy f32
    i = np.arange(total, dtype=np.int32)
    row = np.minimum(np.searchsorted(al[1:], i, side="right"), vocab - 1)
    pos = (i - al[row]).astype(np.int32)
    ln = np.maximum(lens[row], 1).astype(np.float32)
    doc = ((pos.astype(np.float32) + u) / ln * F32(n_docs)).astype(np.int32)
    doc = np.clip(doc, 0, n_docs - 1)
    pad = pos >= lens[row]
    np.testing.assert_array_equal(doc2.numpy().reshape(-1),
                                  np.where(pad, n_docs, doc))
    np.testing.assert_array_equal(tf2.numpy().reshape(-1),
                                  np.where(pad, 0, tf))
    flat_d, flat_t = doc2.numpy().reshape(-1), tf2.numpy().reshape(-1)
    assert (flat_d[pad] == n_docs).all() and (flat_t[pad] == 0).all()
    repeats = 0
    for r in range(vocab):
        d = flat_d[row_start[r] : row_start[r] + lens[r]]
        assert (d < n_docs).all() and (np.diff(d) >= 0).all(), r
        repeats += int((np.diff(d) == 0).sum())
    assert repeats > 0, "no row holds a doc twice"


@pytest.mark.parametrize("kind", ["bm25", "tfidf"])
def test_engine_from_planes_equals_jax_build(kind):
    """The port's build_synth_engine has bench.py's vocabulary, df,
    geometry, doc stats and plane shapes (only the draw differs); on the
    JAX build's doc/tf planes its value plane equals the JAX plane's
    bits, or oracle/spec.py's where the JAX plane is off the spec."""
    jeng, jdf, jtok = _jax_synth(kind)
    rh, rd = jeng.segments[0]
    peng, pdf, ptok = bench.build_synth_engine(
        N_DOCS, VOCAB, AVG_TERMS, _cfgs(kind)[1], seed=1, device="cpu")
    ph, pd = peng.segments[0]
    np.testing.assert_array_equal(pdf, jdf)
    assert ptok == jtok
    for f in ("term_hash", "df", "dl", "alive", "indptr", "row_start"):
        np.testing.assert_array_equal(getattr(ph, f), getattr(rh, f), f)
    for f in ("indptr", "row_start", "dl", "alive", "inv_norm", "post_doc",
              "post_tf", "post_val"):
        want = np.asarray(getattr(rd, f))
        got = getattr(pd, f).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, f
        if f not in ("post_doc", "post_tf", "post_val"):
            np.testing.assert_array_equal(got.view(np.uint8),
                                          want.view(np.uint8), f)
    a, b = peng.stats, jeng.stats
    np.testing.assert_array_equal(a.vocab, b.vocab)
    np.testing.assert_array_equal(a.df, b.df)
    assert (a.n_alive, a.total_len_alive) == (b.n_alive, b.total_len_alive)

    got = _port_on_jax_planes(kind).segments[0][1].post_val.numpy()
    jax_v = np.asarray(rd.post_val)
    d2, t2 = np.asarray(rd.post_doc), np.asarray(rd.post_tf)
    real = t2 > 0
    sc = _cfgs(kind)[1].scoring
    if kind == "bm25":
        avgdl = spec.avgdl_of(int(rh.dl.sum()), N_DOCS)
        vals = spec.val_bm25(t2[real], rh.dl[d2[real]], sc.k1, sc.b, avgdl)
    else:
        vals = spec.val_tfidf(t2[real], np.asarray(rd.inv_norm)[d2[real]])
    want = np.zeros_like(jax_v)
    want[real] = vals.view(np.int32)
    np.testing.assert_array_equal(got, want)  # padding: +0.0 bits
    off_spec = jax_v != want
    np.testing.assert_array_equal(got != jax_v, off_spec)


@pytest.mark.parametrize("k", [10, 64])
def test_search_equals_jax_engine(k):
    """With the JAX build's value plane loaded (as a checkpoint's stored
    planes are served), every scorer's ids and int32 scores over
    make_batches text equal the JAX engine's."""
    jeng, jdf, jtok = _jax_synth("bm25")
    peng = _port_on_jax_planes("bm25")
    seg = peng.segments[0][1]
    peng.segments[0][1] = dataclasses.replace(
        seg, post_val=torch.from_numpy(np.array(jeng.segments[0][1].post_val)))
    batches, _avg = bench.make_batches(jdf, jtok, NQ, 8, 2, seed=7)
    batches[1][:3] = ["", "zzznotaword", batches[1][3].split()[0]]
    for batch in batches:
        want = jeng.search(batch, k=k)
        assert (want[0][:, 0] >= 0).sum() > NQ // 2
        for scorer in (None, "fused", "xla_rank"):
            peng.scorer = scorer
            got = peng.search(batch, k=k)
            np.testing.assert_array_equal(got[0], want[0], str(scorer))
            np.testing.assert_array_equal(got[1], want[1], str(scorer))


def test_engine_hbm_bytes_equals_bench_py():
    """engine_hbm_bytes counts what bench.py's counts: the segment's
    tensors, then the doc-quantile tables once they are cached."""
    jeng, _jdf, _jtok = _jax_synth("bm25")
    peng = _port_on_jax_planes("bm25")
    base = bench.engine_hbm_bytes(peng)
    assert base == ref_bench.engine_hbm_bytes(jeng)
    assert base == peng.resident_bytes()
    ph, pd = peng.segments[0]
    rh, rd = jeng.segments[0]
    offs_p, _d = peng._doc_quantiles(0, ph, pd)
    offs_r, _d = jeng._doc_quantiles(rh, rd)
    np.testing.assert_array_equal(offs_p, offs_r)
    with_tables = bench.engine_hbm_bytes(peng)
    assert with_tables == ref_bench.engine_hbm_bytes(jeng)
    assert with_tables == base + offs_p.size * 4


_PORT = {}


def _port_synth():
    if not _PORT:
        cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
        eng, df, tok = bench.build_synth_engine(
            N_DOCS, VOCAB, AVG_TERMS, cfg, seed=1, device="cpu",
            gen_chunk=1 << 16)
        batches, _avg = bench.make_batches(df, tok, NQ, 8, 2, seed=7)
        _PORT.update(eng=eng, cfg=cfg, df=df, batches=batches,
                     ref0=eng.search(batches[0], k=10))
    return _PORT


@pytest.mark.parametrize("leg", ["step_only", "wo_analysis", "sharded"])
def test_leg_returns_search_results(leg):
    """The device-step replay, the serving loop without analysis and the
    1-shard sharded wrapper each give search's results for batch 0."""
    p = _port_synth()
    eng, batches, ref0 = p["eng"], p["batches"], p["ref0"]
    assert (ref0[0][:, 0] >= 0).all()
    pre = [eng.frontend.analyze(b, eng.stats) for b in batches]
    if leg == "step_only":
        qps, got = bench.step_only_qps(eng, pre[0], 10, 3, 2, NQ, "step")
        assert qps > 0
        step, args, kw, meta = bench.capture_step(eng, pre[1], 10)
        bench.check_same(eng._collect((step(*args, **kw), *meta)),
                         eng.search(batches[1], k=10), "batch 1 replay")
    elif leg == "wo_analysis":
        qps, got = bench.run_wo_analysis(eng, pre, 3, 10, 2, NQ)
        assert qps > 0
    else:
        deng = bench.sharded_from_engine(eng, p["cfg"])
        seg = eng.segments[0][1]
        assert deng.index.post_doc[0] is seg.post_doc
        assert deng.index.post_val[0] is seg.post_val
        got = deng.search(batches[0], k=10)
        sh = bench.run_sharded(eng, p["cfg"], batches, NQ, 2, 10, 2, 1,
                               ref0)
        assert len(sh["passes"]) == 5 and sh["best"] > 0
    bench.check_same(got, ref0, leg)


@pytest.mark.parametrize("kind", ["bm25", "tfidf"])
def test_device_pack_equals_host_planes(kind):
    """pack_triples (device_pack, aligned_geometry, device_align_planes,
    device_materialize_vals) on drawn triples, several draw chunks of
    them, equals the host build's planes of the same triples; and
    bench_device_pack runs it over the engine's tables."""
    cfg = _cfgs(kind)[1]
    n_docs, vocab = 800, 500
    eng, df, _tok = bench.build_synth_engine(n_docs, vocab, 10, cfg,
                                             device="cpu")
    r, d, t = bench.draw_triples(n_docs, df, "cpu", chunk=1000)
    assert r.numel() == df.sum() > 3000
    host0, seg0 = eng.segments[0]
    k_doc = torch.from_numpy(builder._pad(
        builder.host_k_doc(host0.dl, cfg, eng.stats), seg0.n_docs_pad, 0,
        np.float32))
    doc2, val2, tf2, indptr, row_start = bench.pack_triples(
        r, d, t, vocab, n_docs, cfg, k_doc, seg0.inv_norm, seg0.alive)
    _r, hd, ht, h_indptr = builder.host_pack(r.numpy(), d.numpy(), t.numpy(),
                                              vocab, n_docs)
    np.testing.assert_array_equal(indptr, h_indptr)
    h_rs, h_x = builder.aligned_geometry(h_indptr, cfg.nnz_pad_to)
    np.testing.assert_array_equal(row_start, h_rs)
    vals = builder.materialize_vals(
        hd, ht.astype(F32), host0.dl.astype(F32),
        seg0.inv_norm.numpy()[:n_docs], cfg, eng.stats)
    for got, want in zip((doc2, val2, tf2), builder._host_planes(
            hd, vals, ht, h_indptr, h_rs, h_x, n_docs)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert bench.bench_device_pack(n_docs, vocab, df, cfg, eng) > 0


_TINY = {
    "BENCH_DOCS": "2000", "BENCH_NQ": "16", "BENCH_ITERS": "1",
    "BENCH_BATCHES": "1", "BENCH_PASSES": "1", "BENCH_BUILD": "0",
    "BENCH_SHARDS": "1", "BENCH_PACK": "1", "BENCH_8M": "0",
    "BENCH_STREAM": "0",
}


def test_failing_leg_fails_the_run(monkeypatch, capsys):
    """A leg that raises fails main: the error propagates and no JSON
    line is printed."""
    for key, val in _TINY.items():
        monkeypatch.setenv(key, val)

    def boom(*_a, **_kw):
        raise RuntimeError("injected leg failure")

    monkeypatch.setattr(bench, "bench_device_pack", boom)
    with pytest.raises(RuntimeError, match="injected leg failure"):
        bench.main(device="cpu")
    out = capsys.readouterr().out
    assert not [ln for ln in out.splitlines() if ln.startswith("{")], out


def test_deadline_skips_legs_not_started(monkeypatch, capsys):
    """Past BENCH_DEADLINE an optional leg that has not started is
    skipped and its key is null; the primary legs still run, and
    deadline 0 never skips."""
    legs = bench.Legs("cpu", 5)
    legs.t0 -= 10
    ran = []
    assert legs.run("x", lambda: ran.append("x")) is None
    assert legs.run("y", lambda: ran.append("y") or 1, optional=False) == 1
    never = bench.Legs("cpu", 0)
    never.t0 -= 1e6
    assert never.run("z", lambda: ran.append("z") or 2) == 2
    assert ran == ["y", "z"]

    class Late(bench.Legs):
        def __init__(self, device, deadline):
            super().__init__(device, deadline)
            self.t0 -= 1e6

    for key, val in _TINY.items():
        monkeypatch.setenv(key, val)
    monkeypatch.setenv("BENCH_DEADLINE", "60")
    monkeypatch.setattr(bench, "Legs", Late)
    assert bench.main(device="cpu") == 0
    res = json.loads(capsys.readouterr().out.strip())
    assert res["value"] > 0 and len(res["passes"]) == 1
    assert res["step_qps"] is None and res["sharded"] is None
    assert res["device_pack_secs"] is None
