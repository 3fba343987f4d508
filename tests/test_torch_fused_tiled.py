"""The heavy buckets' tiled scorer (ops/tiled.py, csrc/fused_tiled.cu)
through its plain mirror, which is what fused_search runs on CPU tensors
for a bucket of r_c >= TILED_MIN_RC rows: against the plain scorer
(ops/packed.py search_packed_tables) on the same plan tables, with docs
at tile edges, empty tiles, fewer candidates than k, k in {1, 10, 100,
128}, a doc twice in a row, docs past n_docs, blocks reordered and
skipped; against the oracle through the CPU engine, bm25 and tf-idf; the
routing by the bucket's shape (r_c, doc limits, the tile block's fit);
the `step.tiled_pairs` counter; and the kernel's compile-time constants
against the wrapper's."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from document_search_engine_tpu_torch import SearchEngine
from document_search_engine_tpu_torch.config import IndexConfig, ScoringConfig
from document_search_engine_tpu_torch.corpus.synth import (
    synth_corpus,
    synth_queries,
)
from document_search_engine_tpu_torch.engine.step_graph import StepGraphs
from document_search_engine_tpu_torch.index import builder
from document_search_engine_tpu_torch.ops import fused as F
from document_search_engine_tpu_torch.ops import packed as P
from document_search_engine_tpu_torch.ops import tiled as T
from document_search_engine_tpu_torch.oracle import OracleEngine
from document_search_engine_tpu_torch.utils import prof
from test_torch_trace_spans import fake_capture

torch.set_num_threads(1)

SCALE = float(np.float32(2.0**16))
CLIP = float(np.float32(65075262.0))
BLOCK = 512


def planes(rows_docs, n_docs, rng):
    """Aligned (X, 128) doc and value planes, row_start and indptr
    (int32 tensors) from each term row's doc-ascending docs, by the
    builder's host layout."""
    lens = np.array([len(d) for d in rows_docs], np.int64)
    indptr = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    row_start, x_rows = builder.aligned_geometry(indptr, 1)
    docs = np.concatenate(rows_docs).astype(np.int32)
    vals = rng.random(len(docs), dtype=np.float32) * 0.9 + 0.05
    d2, v2, _ = builder._host_planes(docs, vals, np.ones(len(docs), np.int32),
                                     indptr, row_start, x_rows, n_docs)
    t = torch.from_numpy
    return (t(d2), t(v2), t(row_start.astype(np.int32)),
            t(indptr.astype(np.int32)))


def random_rows(rng, n_terms, n_docs, max_len, edge=None, band=None):
    """Doc-ascending rows: with `edge`, every other row holds the docs
    around the multiples of edge; with `band`, each row keeps inside one
    doc band of that width (the tiles outside it are empty)."""
    out = []
    for t in range(n_terms):
        n = int(rng.integers(1, max_len))
        lo, hi = 0, n_docs
        if band is not None:
            lo = int(rng.integers(0, max(1, n_docs - band)))
            hi = min(n_docs, lo + band)
        d = rng.choice(np.arange(lo, hi), size=min(n, hi - lo),
                       replace=False)
        if edge is not None and t % 2 == 0:
            e = np.arange(edge, n_docs, edge)
            d = np.concatenate([d, e - 1, e])
        out.append(np.unique(d[(d >= 0) & (d < n_docs)]))
    return out


def plan(row_start, indptr, rows, coeff, block=BLOCK):
    """The plan tables of expand_plan_tables and their n_blocks."""
    lens = np.where(coeff > 0, indptr.numpy()[rows + 1]
                    - indptr.numpy()[rows], 0)
    need = int((-(-lens // block)).sum(1).max())
    nb = 1 << int(np.ceil(np.log2(max(need, 1))))
    tabs = F.expand_plan_tables(row_start, indptr, torch.from_numpy(rows),
                                torch.from_numpy(coeff).view(torch.int32),
                                nb, block)
    return tabs, nb


def queries(rng, n_terms, nq, s):
    rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
    coeff = (rng.random((nq, s)) * 1.5 + 0.05).astype(np.float32)
    coeff[rng.random((nq, s)) < 0.25] = 0.0  # missing slots
    coeff[1] = 0.0  # an empty query between real ones
    return rows, coeff


def both(d2, v2, tabs, nb, *, s, k, n_docs, tile, tpb=T.TILES_PER_BLOCK,
         r_c=4096):
    got = T.tiled_search_plain(d2, v2, *tabs, block=BLOCK, k=k,
                               n_docs=n_docs, scale=SCALE, clip=CLIP,
                               r_c=r_c, tile=tile, tiles_per_block=tpb)
    want = P.search_packed_tables(d2, v2, *tabs[:3], SCALE, CLIP, 0,
                                  n_blocks=nb, block=BLOCK, s=s, k=k,
                                  n_docs=n_docs)
    return got, want


def assert_equal(got, want):
    assert torch.equal(got[0], want[0]), "vals"
    assert torch.equal(got[1], want[1]), "docs"


@pytest.mark.parametrize("layout", ["edges", "empty_tiles", "few"])
@pytest.mark.parametrize("k", [1, 10, 100, 128])
def test_mirror_matches_plain(k, layout):
    """Docs on both sides of every tile edge, rows confined to doc bands
    (most tiles empty for a query), and rows so short that a query has
    fewer candidates than k; at a tile of 64 docs (many tiles, several a
    block) and at the card's."""
    rng = np.random.default_rng(k * 7 + len(layout))
    n_docs = 3000
    edge = 64 if layout == "edges" else None
    band = 200 if layout == "empty_tiles" else None
    max_len = 12 if layout == "few" else 700
    rows_docs = random_rows(rng, 16, n_docs, max_len, edge=edge, band=band)
    d2, v2, rs, ip = planes(rows_docs, n_docs, rng)
    rows, coeff = queries(rng, 16, 6, 4)
    tabs, nb = plan(rs, ip, rows, coeff)
    for tile, tpb in ((64, 3), (T.TILE_DOCS, T.TILES_PER_BLOCK)):
        got, want = both(d2, v2, tabs, nb, s=4, k=k, n_docs=n_docs,
                         tile=tile, tpb=tpb)
        assert_equal(got, want)
    if layout == "few":
        assert (got[1] == -1).any()  # some query ran out of candidates


def test_a_doc_twice_in_a_row_adds_twice():
    """ROADMAP's duplicate-doc hazard: a doc twice in one row. The mirror
    adds both pairs, as the plain scorer's run-sums and the dense scatter
    do (the doc occurs at most s times in a query)."""
    rng = np.random.default_rng(31)
    n_docs = 2000
    rows_docs = random_rows(rng, 8, n_docs, 400)
    for t in (0, 3):
        d = rows_docs[t]
        rows_docs[t] = np.sort(np.append(d, d[len(d) // 2]))
    d2, v2, rs, ip = planes(rows_docs, n_docs, rng)
    rows = np.array([[0, 1, 2], [3, 4, 5], [0, 3, 6]], np.int32)
    coeff = np.full(rows.shape, 0.7, np.float32)
    tabs, nb = plan(rs, ip, rows, coeff)
    got, want = both(d2, v2, tabs, nb, s=3, k=128, n_docs=n_docs, tile=128)
    assert_equal(got, want)
    # the dense scatter: every pair of the query added into its doc
    ci = P.quantize(torch.tensor(0.7), v2.view(torch.float32), SCALE, CLIP,
                    torch.ones_like(d2, dtype=torch.bool)).reshape(-1)
    for q, terms in enumerate(rows):
        dense = np.zeros(n_docs, np.int64)
        for t in terms:
            at = int(rs[t])
            span = slice(at, at + int(ip[t + 1] - ip[t]))
            np.add.at(dense, d2.reshape(-1)[span].numpy(), ci[span].numpy())
        top = np.lexsort((np.arange(n_docs), -dense))[:128]
        top = top[dense[top] > 0]
        assert got[1][q, :len(top)].tolist() == top.tolist()
        assert got[0][q, :len(top)].tolist() == dense[top].tolist()


def test_docs_past_n_docs_are_not_candidates():
    """Postings of docs >= n_docs (a shard's sentinel range) are read by
    neither scorer: the last tile's edge is n_docs."""
    rng = np.random.default_rng(41)
    n_docs, stored = 1000, 1300
    rows_docs = random_rows(rng, 10, stored, 600)
    d2, v2, rs, ip = planes(rows_docs, stored, rng)
    rows, coeff = queries(rng, 10, 5, 3)
    tabs, nb = plan(rs, ip, rows, coeff)
    for tile in (64, 1024, 16384):
        got, want = both(d2, v2, tabs, nb, s=3, k=100, n_docs=n_docs,
                         tile=tile)
        assert_equal(got, want)
        assert int(got[1].max()) < n_docs


@pytest.mark.parametrize("tpb", [1, 2, 5])
def test_survivors_are_each_chunks_top_k(tpb):
    """Each chunk's survivors are its tiles' top k, descending, and the
    merge of every chunk's is the plain ranking."""
    rng = np.random.default_rng(51 + tpb)
    n_docs, tile, k = 2500, 128, 10
    rows_docs = random_rows(rng, 12, n_docs, 900)
    d2, v2, rs, ip = planes(rows_docs, n_docs, rng)
    rows, coeff = queries(rng, 12, 4, 4)
    tabs, nb = plan(rs, ip, rows, coeff)
    surv = T.tiled_survivors(d2, v2, *tabs, block=BLOCK, k=k, n_docs=n_docs,
                             scale=SCALE, clip=CLIP, r_c=4096, tile=tile,
                             tiles_per_block=tpb)
    assert surv.shape == (4, T.tiled_chunks(n_docs, tile, tpb), k)
    assert (np.diff(surv, axis=2) <= 0).all()
    for q in range(4):
        for c in range(surv.shape[1]):
            docs = 0x7FFFFFFF - (surv[q, c][surv[q, c] > 0] & 0xFFFFFFFF)
            assert ((docs >= c * tpb * tile)
                    & (docs < (c + 1) * tpb * tile)).all()
    vals, docs = T.merge_survivors(surv, k)
    want = P.search_packed_tables(d2, v2, *tabs[:3], SCALE, CLIP, 0,
                                  n_blocks=nb, block=BLOCK, s=4, k=k,
                                  n_docs=n_docs)
    assert_equal((torch.from_numpy(vals), torch.from_numpy(docs)), want)


def test_runs_of_a_real_plan_are_its_live_slots():
    """expand_plan_tables' plan has one run a slot with postings: the
    term row's start row, its length and its coefficient."""
    rng = np.random.default_rng(61)
    rows_docs = random_rows(rng, 9, 4000, 2500)
    d2, v2, rs, ip = planes(rows_docs, 4000, rng)
    rows, coeff = queries(rng, 9, 5, 4)
    tabs, nb = plan(rs, ip, rows, coeff)
    for q, runs in enumerate(T.tiled_runs(*tabs, block=BLOCK, r_c=4096)):
        live = [j for j in range(4) if coeff[q, j] > 0]
        assert list(runs["row"]) == [int(rs[rows[q, j]]) // 128 for j in live]
        assert list(np.diff(runs["off"])) == [
            int(ip[rows[q, j] + 1] - ip[rows[q, j]]) for j in live]
        assert list(runs["coeff"]) == [
            int(np.float32(coeff[q, j]).view(np.int32)) for j in live]


@pytest.mark.parametrize("change", ["reversed", "skipped"])
def test_mirror_on_reordered_and_skipped_blocks(change):
    """Plan blocks out of order (each then a run of its own) or skipped
    (srcrow -1) inside a slot: the mirror still scores exactly what the
    plain scorer reads."""
    rng = np.random.default_rng(71)
    n_docs = 3000
    rows_docs = random_rows(rng, 8, n_docs, 2900)
    d2, v2, rs, ip = planes(rows_docs, n_docs, rng)
    rows, coeff = queries(rng, 8, 4, 3)
    tabs, nb = plan(rs, ip, rows, coeff, block=128)
    tabs = [t.clone() for t in tabs]
    if change == "reversed":
        tabs = [t.flip(-1).contiguous() for t in tabs]
    else:
        tabs[0][:, :, 1::3] = -1
    got = T.tiled_search_plain(d2, v2, *tabs, block=128, k=50,
                               n_docs=n_docs, scale=SCALE, clip=CLIP,
                               r_c=4096, tile=256, tiles_per_block=2)
    want = P.search_packed_tables(d2, v2, *tabs[:3], SCALE, CLIP, 0,
                                  n_blocks=nb, block=128, s=3, k=50,
                                  n_docs=n_docs)
    assert_equal(got, want)


@pytest.mark.parametrize("dlim", [False, True])
@pytest.mark.parametrize("r_c", [8, 16, 32, 64, 128, 4096])
def test_routing_by_r_c(monkeypatch, r_c, dlim):
    """fused_search takes the tiled path exactly for r_c >= TILED_MIN_RC
    without doc limits, and the plain scorer otherwise; both give the
    same answer."""
    calls = []
    real = T.tiled_search_plain

    def counting(*a, **kw):
        calls.append(kw["r_c"])
        return real(*a, **kw)

    monkeypatch.setattr(T, "tiled_search_plain", counting)
    rng = np.random.default_rng(81)
    n_docs = 1500
    rows_docs = random_rows(rng, 6, n_docs, 300)
    d2, v2, rs, ip = planes(rows_docs, n_docs, rng)
    rows, coeff = queries(rng, 6, 3, 2)
    tabs, nb = plan(rs, ip, rows, coeff)
    lim = (torch.tensor([[0, n_docs]] * 3, dtype=torch.int32)
           .reshape(3, 1, 2) if dlim else None)
    got = F.fused_search(d2, v2, *tabs, n_blocks=nb, block=BLOCK, s=2, k=10,
                         n_docs=n_docs, scale=SCALE, clip=CLIP, r_c=r_c,
                         key_bits=F.key_bits_for(2, n_docs), dlim=lim)
    tiled = not dlim and r_c >= F.TILED_MIN_RC
    assert T.tiled_route(mode="fused", k=10, split=dlim, r_c=r_c,
                         n_blocks=nb, s=2) == tiled
    assert calls == ([r_c] if tiled else [])
    want = P.search_packed_tables(d2, v2, *tabs[:3], SCALE, CLIP, 0,
                                  n_blocks=nb, block=BLOCK, s=2, k=10,
                                  n_docs=n_docs)
    assert_equal(got, want)


def _heavy_corpus(seed):
    """Docs whose frequent words make queries of over 16,384 postings
    (buckets of r_c 256, the tiled path's), and one-word queries of a few
    postings (light buckets)."""
    docs = synth_corpus(n_docs=6000, vocab_size=400, mean_len=30, seed=seed)
    qs = synth_queries(docs, n_queries=24, terms_per_query=8, seed=seed + 1)
    words, counts = np.unique(" ".join(docs).split(), return_counts=True)
    light = list(words[np.argsort(counts, kind="stable")[:4]])
    return docs, qs + ["", "zzznotaword"] + light


@pytest.mark.parametrize("min_rc", [None, 8])
@pytest.mark.parametrize("kind", ["bm25", "tfidf"])
def test_engine_matches_oracle(monkeypatch, kind, min_rc):
    """The CPU engine's fused scorer (the tiled mirror for its heavy
    buckets; with min_rc 8, for every bucket) against the oracle and the
    plain scorer, k 10 and 100, over two segments."""
    if min_rc is not None:
        monkeypatch.setattr(F, "TILED_MIN_RC", min_rc)
    calls = []
    real = T.tiled_search_plain
    monkeypatch.setattr(T, "tiled_search_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    docs, qs = _heavy_corpus(101)
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    eng, plain = (SearchEngine(cfg, device="cpu") for _ in range(2))
    ora = OracleEngine(cfg)
    for e in (eng, plain, ora):
        e.build(docs[:5800])
        e.add_docs(docs[5800:])
    eng.scorer, plain.scorer = "fused", "xla"
    ids, scores = ora.search(qs, k=100)  # k 10's answer is its first 10
    for k in (10, 100):
        got = eng.search(qs, k=k)
        np.testing.assert_array_equal(got[0], ids[:, :k])
        np.testing.assert_array_equal(got[1], scores[:, :k])
        np.testing.assert_array_equal(got[0], plain.search(qs, k=k)[0])
    assert calls  # the heavy buckets took the tiled path


@pytest.mark.parametrize("scorer,split_rows,min_rc", [
    ("fused", None, None), ("fused", None, 8), ("fused", None, 1 << 20),
    ("fused", 4, None), ("xla", None, None)])
def test_step_tiled_pairs_is_the_heavy_buckets_pairs(monkeypatch, scorer,
                                                     split_rows, min_rc):
    """`step.tiled_pairs` equals the pairs of the plan tables that reach
    the tiled path (each query's run table), counted where they arrive;
    every pair when every bucket routes there, none on the split path
    (doc limits) or the plain scorer."""
    if min_rc is not None:
        monkeypatch.setattr(F, "TILED_MIN_RC", min_rc)
    seen = []
    real = T.tiled_search_plain

    def counting(d2, v2, sr, rm, ab, dst, **kw):
        runs = T.tiled_runs(sr, rm, ab, dst, block=kw["block"],
                            r_c=kw["r_c"])
        seen.append(sum(int(r["off"][-1]) for r in runs))
        return real(d2, v2, sr, rm, ab, dst, **kw)

    monkeypatch.setattr(T, "tiled_search_plain", counting)
    docs, qs = _heavy_corpus(111)
    eng = SearchEngine(device="cpu")
    eng.build(docs)
    eng.scorer, eng.split_rows = scorer, split_rows
    eng._graphs = StepGraphs("cpu", capturer=fake_capture)
    prof.reset()
    eng._collect(eng._dispatch(eng.frontend.analyze_rows(qs, eng.stats), 10))
    pairs, tiled = prof.total("step.pairs"), prof.total("step.tiled_pairs")
    prof.reset()
    # the warm-up and the capture each ran the step once
    assert tiled == sum(seen) // 2
    assert pairs > 0
    if scorer == "fused" and split_rows is None and min_rc == 8:
        assert tiled == pairs
    elif scorer == "fused" and split_rows is None and min_rc is None:
        assert 0 < tiled < pairs
    else:
        assert tiled == 0


@pytest.mark.parametrize("s", [1, 8, 32])
@pytest.mark.parametrize("n_blocks", [4, 256, 1024, 8192])
def test_the_route_holds_the_tile_block_to_shared_memory(n_blocks, s):
    """A tile block's shared memory grows with n_blocks (its run table):
    it fits for the plan shapes the planner makes at the cells' sizes
    (n_blocks up to 1,024 blocks of 4,096, s up to 32 slots), and at 8,192
    blocks (a query of over 16.7M postings at block 4,096) it does not,
    so tiled_route leaves the bucket to the fused kernel."""
    fits = T.tiled_smem_bytes(n_blocks, s) <= T.TILED_MAX_SMEM
    assert fits == (n_blocks <= 1024)
    assert T.tiled_route(mode="fused", k=10, split=False, r_c=4096,
                         n_blocks=n_blocks, s=s) == fits


@pytest.mark.parametrize("mode,k,tiled", [
    ("fused", 128, True), ("fused", 129, False), ("fused_dv", 10, False),
    ("xla", 10, False), ("xla_rank", 10, False)])
def test_the_route_is_the_fused_scorers(mode, k, tiled):
    """Only the buckets that _batch_step sends to fused_search (mode
    "fused", k <= MAX_K) can take the tiled kernels."""
    assert T.tiled_route(mode=mode, k=k, split=False, r_c=4096,
                         n_blocks=64, s=8) == tiled


def test_a_plan_too_wide_for_a_tile_block_takes_the_fused_kernel(
        monkeypatch):
    """fused_search at r_c 4,096 with 8,192 plan blocks: the tile block
    would not fit, so the bucket takes the fused kernel's route (the
    plain scorer on CPU tensors) and the tiled mirror is not called."""
    calls = []
    monkeypatch.setattr(T, "tiled_search_plain",
                        lambda *a, **kw: calls.append(1))
    rng = np.random.default_rng(91)
    n_docs = 2000
    d2, v2, rs, ip = planes(random_rows(rng, 6, n_docs, 900), n_docs, rng)
    rows, coeff = queries(rng, 6, 3, 2)
    nb = 8192
    tabs = F.expand_plan_tables(rs, ip, torch.from_numpy(rows),
                                torch.from_numpy(coeff).view(torch.int32),
                                nb, BLOCK)
    got = F.fused_search(d2, v2, *tabs, n_blocks=nb, block=BLOCK, s=2, k=10,
                         n_docs=n_docs, scale=SCALE, clip=CLIP, r_c=4096,
                         key_bits=F.key_bits_for(2, n_docs))
    assert not calls
    want = P.search_packed_tables(d2, v2, *tabs[:3], SCALE, CLIP, 0,
                                  n_blocks=nb, block=BLOCK, s=2, k=10,
                                  n_docs=n_docs)
    assert_equal(got, want)


@pytest.mark.parametrize("name,const", [
    ("kTileLog2", lambda: T.TILE_DOCS.bit_length() - 1),
    ("kTilesPerBlock", lambda: T.TILES_PER_BLOCK),
    ("kTiledThreads", lambda: T.TILED_THREADS),
    ("kTiledMaxSmem", lambda: T.TILED_MAX_SMEM)])
def test_the_wrappers_constants_are_the_kernels(name, const):
    """ops/tiled.py's copies of csrc/fused_tiled.cu's compile-time
    constants, which size the survivors' scratch and decide the route."""
    src = (Path(T.__file__).parent.parent / "csrc" / "fused_tiled.cu"
           ).read_text()
    m = re.search(rf"constexpr int {name} = ([^;]+);", src)
    assert m is not None
    assert eval(m.group(1), {"__builtins__": {}}) == const()
    assert T.TILE_DOCS & (T.TILE_DOCS - 1) == 0
