"""The torch port's sharded engine (CPU meshes): DistributedSearchEngine
over make_mesh(n, device="cpu") against the port's SearchEngine, the
frozen oracle and the JAX package's DistributedSearchEngine. Ids and
int32 scores must be bit-identical at 1, 2, 4 and 8 shards, for tfidf
and bm25, in the fused and xla_rank modes (on the CPU each kernel
wrapper takes its plain version), at k = 200, with more shards than
docs, through add, delete, compact, the O(delta) last-shard add, a
streaming build and the host build path, and for the rerank. Against
the JAX package (its host build, device_build = False, which is
spec-exact on XLA:CPU, and its default xla scorer): ids and scores,
every shard's value-plane bits, each build path's doc planes against
the same JAX path, merge_candidates on random ties, plan_batch_sharded
and split_pieces_sharded, and the state index/convert.py carries
across. The mesh guards: repeated devices, no mixed CPU/CUDA mesh, the
card by default and no CUDA means raise. Each package's engine is
configured with its own package's IndexConfig."""
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
from document_search_engine_tpu_torch.index import builder as port_builder
from document_search_engine_tpu_torch.oracle import OracleEngine
from document_search_engine_tpu_torch.parallel import dist as port_dist
from document_search_engine_tpu_torch.parallel import mesh as port_mesh

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

KINDS = ["tfidf", "bm25"]


@pytest.fixture(scope="module")
def corpus():
    docs = synth_corpus(n_docs=90, vocab_size=600, mean_len=35, seed=11)
    queries = synth_queries(docs, n_queries=9, terms_per_query=5, seed=12)
    queries += ["", "zzzunknown"]
    return docs, queries


def _cfg(kind):
    return port_config.IndexConfig(
        scoring=port_config.ScoringConfig(kind=kind)
    )


def _dist(kind, n_shards, scorer=None):
    eng = DistributedSearchEngine(
        _cfg(kind), mesh=make_mesh(n_shards, device="cpu")
    )
    eng.scorer = scorer
    return eng


def _single(kind):
    return SearchEngine(_cfg(kind), device="cpu")


def _ref_dist(kind, n_shards):
    eng = RefDist(
        IndexConfig(scoring=ScoringConfig(kind=kind)),
        mesh=ref_mesh(n_shards),
    )
    eng.device_build = False  # spec-exact on XLA:CPU
    return eng


def _assert_same(got, want, what=""):
    np.testing.assert_array_equal(got[0], want[0], f"{what} ids")
    np.testing.assert_array_equal(got[1], want[1], f"{what} scores")


# ------------------------------------------------- against the port itself
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_shard_count_invariance(corpus, kind, n_shards):
    docs, queries = corpus
    ref = _single(kind)
    ref.build(docs)
    dist = _dist(kind, n_shards)
    dist.build(docs)
    _assert_same(dist.search(queries, k=10), ref.search(queries, k=10))


def test_sharded_matches_oracle(corpus):
    docs, queries = corpus
    ora = OracleEngine(_cfg("bm25"))
    ora.build(docs)
    dist = _dist("bm25", 4)
    dist.build(docs)
    _assert_same(dist.search(queries, k=10), ora.search(queries, k=10))


@pytest.mark.parametrize("scorer", ["fused", "xla_rank"])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_scorer_invariance(corpus, scorer, n_shards):
    """The card's scorer modes (their plain versions on the CPU) over
    the fleet-uniform sentinel d_pad - 1 and the global-row tables."""
    docs, queries = corpus
    ref = _single("bm25")
    ref.build(docs)
    dist = _dist("bm25", n_shards, scorer)
    dist.build(docs)
    _assert_same(dist.search(queries, k=10), ref.search(queries, k=10))


def test_sharded_k_beyond_lane_width(corpus):
    """k > 128: the fused mode takes the plain scorer, uncompacted."""
    docs, queries = corpus
    ref = _single("bm25")
    ref.build(docs)
    dist = _dist("bm25", 4, "fused")
    dist.build(docs)
    _assert_same(dist.search(queries, k=200), ref.search(queries, k=200))


def test_more_shards_than_docs():
    dist = DistributedSearchEngine(mesh=make_mesh(8, device="cpu"))
    dist.build(["only one", "and two", "then three"])
    ids, _scores = dist.search(["two", "three one"], k=3)
    assert ids[0, 0] == 1
    assert set(ids[1, :2].tolist()) == {0, 2}


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_incremental_matches_single(corpus, kind):
    docs, queries = corpus
    single, dist = _single(kind), _dist(kind, 4)
    single.build(docs[:70])
    dist.build(docs[:70])
    assert single.add_docs(docs[70:]) == dist.add_docs(docs[70:])
    _assert_same(dist.search(queries, k=10), single.search(queries, k=10))
    single.delete_docs([0, 35, 71, 89])
    dist.delete_docs([0, 35, 71, 89])
    _assert_same(dist.search(queries, k=10), single.search(queries, k=10))


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_delete_then_add_matches_single(corpus, kind):
    """add_docs after delete_docs must not resurrect tombstoned docs' df
    counts when rebuilding the last shard."""
    docs, queries = corpus
    single, dist = _single(kind), _dist(kind, 4)
    single.build(docs[:70])
    dist.build(docs[:70])
    single.delete_docs([2, 40, 65, 69])
    dist.delete_docs([2, 40, 65, 69])
    single.add_docs(docs[70:])
    dist.add_docs(docs[70:])
    _assert_same(dist.search(queries, k=10), single.search(queries, k=10))


def test_sharded_incremental_is_o_delta(corpus, monkeypatch):
    """A delete refreshes values on the devices (the doc planes stay the
    same tensors), and an add that fits the padded shapes updates only
    the last shard: assemble_sharded is never called."""
    docs, queries = corpus
    dist = _dist("bm25", 4)
    dist.build(docs[:80])
    pd_before = list(dist.index.post_doc)

    def boom(*a, **kw):
        raise AssertionError("assemble_sharded called on the O(delta) path")

    monkeypatch.setattr(port_dist, "assemble_sharded", boom)
    dist.delete_docs([3, 41])
    assert all(a is b for a, b in zip(dist.index.post_doc, pd_before))
    dist.add_docs([docs[0]])
    # only the last shard's doc plane was replaced
    assert all(a is b for a, b in zip(dist.index.post_doc[:-1],
                                      pd_before[:-1]))
    assert dist.index.post_doc[-1] is not pd_before[-1]
    ref = _single("bm25")
    ref.build(docs[:80])
    ref.delete_docs([3, 41])
    ref.add_docs([docs[0]])
    _assert_same(dist.search(queries, k=10), ref.search(queries, k=10))


def test_sharded_device_build_matches_host(corpus, tmp_path):
    """device build == host build, value planes bit for bit, through a
    delete, an add and a checkpoint reloaded on 2 shards (device-built
    shards re-derive their host CSR on load)."""
    docs, queries = corpus
    dev, host = _dist("bm25", 4), _dist("bm25", 4)
    dev.device_build, host.device_build = True, False
    dev.build(docs)
    host.build(docs)
    assert host.index.df_psum is None and dev.index.df_psum is not None
    for a, b in zip(dev.index.post_val, host.index.post_val):
        assert torch.equal(a, b)
    _assert_same(dev.search(queries, k=10), host.search(queries, k=10))
    for eng in (dev, host):
        eng.delete_docs([5, 60])
        eng.add_docs(docs[:2])
    want = host.search(queries, k=10)
    _assert_same(dev.search(queries, k=10), want)
    path = str(tmp_path / "dev_sharded")
    dev.save(path)
    re = DistributedSearchEngine.load(path, mesh=make_mesh(2, device="cpu"))
    _assert_same(re.search(queries, k=10), want)


def test_spmd_build_df_psum_matches_host_merge(corpus):
    docs, _q = corpus
    dist = _dist("bm25", 4)
    dist.build(docs)
    idx = dist.index
    assert idx.df_psum is not None
    tg = len(idx.stats.vocab)
    np.testing.assert_array_equal(idx.df_psum[:tg], idx.stats.df)
    assert (idx.df_psum[tg:] == 0).all()  # vocab padding rows count 0


def test_spmd_build_is_one_job(corpus, monkeypatch):
    """The sharded device build never falls back to a per-shard
    build_segment_device."""
    docs, _q = corpus

    def boom(*a, **kw):
        raise AssertionError("per-shard build_segment_device called")

    monkeypatch.setattr(port_builder, "build_segment_device", boom)
    dist = _dist("bm25", 4)
    dist.build(docs)
    assert dist.index.df_psum is not None


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_compact_drops_tombstones(corpus, kind):
    docs, queries = corpus
    dist = _dist(kind, 4)
    dist.build(docs)
    dead = [0, 17, 44, 70, 89]
    dist.delete_docs(dead)
    want = dist.search(queries, k=10)
    nnz_before = sum(int(h.indptr[-1]) for h in dist.index.hosts)
    dist.compact()
    assert sum(int(h.indptr[-1]) for h in dist.index.hosts) < nnz_before
    got = dist.search(queries, k=10)
    _assert_same(got, want)
    assert not set(got[0].ravel().tolist()) & set(dead)
    dist.add_docs(docs[:3])
    single = _single(kind)
    single.build(docs)
    single.delete_docs(dead)
    single.compact()
    single.add_docs(docs[:3])
    _assert_same(dist.search(queries, k=10), single.search(queries, k=10))


def test_sharded_build_streaming_equals_bulk(corpus):
    from document_search_engine_tpu_torch.corpus.loader import stream_batches

    docs, queries = corpus
    bulk, stream = _dist("bm25", 4), _dist("bm25", 4)
    bulk.build(docs)
    stream.build_streaming(stream_batches(docs, batch_size=16))
    _assert_same(stream.search(queries, k=10), bulk.search(queries, k=10))
    for a, b in zip(stream.index.post_val, bulk.index.post_val):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_rerank_matches_single(corpus, n_shards):
    """Each shard dots the candidates it owns; the integer psum gives
    the single engine's rerank bit for bit, also after a delete (the
    embeddings re-derive)."""
    docs, queries = corpus
    single, dist = _single("bm25"), _dist("bm25", n_shards)
    single.build(docs)
    dist.build(docs)
    for step in range(2):
        want = single.search_rerank(queries, k=8, candidates=24)
        got = dist.search_rerank(queries, k=8, candidates=24)
        for g, w, name in zip(got, want, ("ids", "rerank", "lex")):
            np.testing.assert_array_equal(g, w, f"step {step} {name}")
        single.delete_docs([4, 61])
        dist.delete_docs([4, 61])


# ------------------------------------------------- against the JAX package
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_shards", [2, 8])
def test_matches_jax_engine(corpus, kind, n_shards):
    """Ids and scores equal the JAX engine's; every shard's value plane
    equals the JAX host build's bits for both of the port's build paths;
    each path's doc plane equals the same JAX path's (the SPMD build
    pads it with d_pad - 1, the host assembly with the shard's n_docs)."""
    docs, queries = corpus
    ref_host = _ref_dist(kind, n_shards)
    ref_host.build(docs)
    ref_dev = _ref_dist(kind, n_shards)
    ref_dev.device_build = True
    ref_dev.build(docs)
    want = ref_host.search(queries, k=10)
    rh, rd = ref_host.index, ref_dev.index
    for device_build, ref_idx in ((True, rd), (False, rh)):
        dist = _dist(kind, n_shards)
        dist.device_build = device_build
        dist.build(docs)
        _assert_same(dist.search(queries, k=10), want, f"{device_build}")
        idx = dist.index
        assert (idx.d_pad, idx.t_pad, idx.x_rows) == (
            rh.d_pad, rh.t_pad, int(rh.post_doc.shape[1]))
        np.testing.assert_array_equal(idx.indptr_g, rh.indptr_g)
        for i in range(n_shards):
            np.testing.assert_array_equal(
                idx.post_val[i].numpy(), np.asarray(rh.post_val[i]),
                f"shard {i} post_val bits, device_build={device_build}")
            np.testing.assert_array_equal(
                idx.post_doc[i].numpy(), np.asarray(ref_idx.post_doc[i]),
                f"shard {i} post_doc, device_build={device_build}")
            np.testing.assert_array_equal(
                idx.post_tf[i].numpy(), np.asarray(ref_idx.post_tf[i]))
            np.testing.assert_array_equal(
                idx.row_start_d[i].numpy(), np.asarray(rh.row_start_d[i]))


def test_merge_candidates_matches_jax():
    """(score desc, gid asc) on rows crowded with ties and dead slots."""
    from document_search_engine_tpu.ops.topk import (
        merge_candidates as ref_merge,
    )
    from document_search_engine_tpu_torch.ops.topk import merge_candidates

    rng = np.random.default_rng(3)
    nq, c = 64, 48
    vals = rng.integers(-1, 6, (nq, c)).astype(np.int32)
    vals[:4] = 3  # all tied
    vals[4] = -1  # all dead
    vals[5, :40] = 2**31 - 1
    gids = np.stack([rng.permutation(10**6)[:c] for _ in range(nq)])
    gids = np.where(vals < 0, -1, gids).astype(np.int32)
    gids[6] = np.arange(c)[::-1]
    for k in (1, 10, 48, 60):
        got = merge_candidates(torch.from_numpy(vals),
                               torch.from_numpy(gids), k)
        want = ref_merge(vals, gids, k=k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), f"k={k}")


def test_sharded_planners_match_jax():
    from document_search_engine_tpu.ops import schedule as ref_s
    from document_search_engine_tpu_torch.ops import schedule as port_s

    rng = np.random.default_rng(5)
    n_shards, nq, s, p, t_pad = 4, 300, 8, 8, 60
    rows = rng.integers(0, t_pad, (nq, s)).astype(np.int32)
    lens_t = rng.integers(0, 9000, (n_shards, t_pad))
    lens_t[:, ::7] = 0  # terms some shards lack
    lens_sh = np.where(rng.random((nq, s)) < 0.7, lens_t[:, rows], 0)
    offs = np.sort(rng.integers(0, 9000, (n_shards, t_pad, p + 1)), axis=2)
    offs[:, :, 0] = 0
    offs[:, :, p] = lens_t
    offs = np.minimum(offs, lens_t[:, :, None]).astype(np.int32)
    for fam, compact in ((port_s.FUSED_FAMILIES, True),
                         (port_s.DEFAULT_FAMILIES, False)):
        got = port_s.plan_batch_sharded(lens_sh, families=fam,
                                        compact=compact)
        want = ref_s.plan_batch_sharded(lens_sh, families=fam,
                                        compact=compact)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1:] == w[1:]
    for thr in (1, 16, 10**6):
        for g, w in zip(
            port_s.split_pieces_sharded(lens_sh, rows, offs, thr, 4096, p),
            ref_s.split_pieces_sharded(lens_sh, rows, offs, thr, 4096, p),
        ):
            np.testing.assert_array_equal(g, w, f"thr={thr}")


@pytest.mark.parametrize("n_shards", [2, 8])
def test_converted_state_matches_jax(corpus, n_shards):
    """index/convert.py sharded_from_reference: a JAX engine's hosts,
    after a delete, assembled on the port's mesh serve the JAX engine's
    results and hold the planes and tables the JAX host assembly makes
    of the same hosts (what its checkpoint load makes; the JAX engine's
    own planes went through its device refresh, 1 ulp off the spec on
    XLA:CPU)."""
    import copy

    from document_search_engine_tpu.parallel.dist import (
        assemble_sharded as ref_assemble,
    )
    from document_search_engine_tpu_torch.index.convert import (
        sharded_from_reference,
    )

    docs, queries = corpus
    ref = _ref_dist("bm25", n_shards)
    ref.build(docs)
    ref.delete_docs([1, 30, 88])
    want = ref.search(queries, k=10)
    dist = _dist("bm25", n_shards)
    dist._set_index(sharded_from_reference(
        ref.index.hosts, dist.config, dist.mesh))
    _assert_same(dist.search(queries, k=10), want)
    idx = dist.index
    rx = ref_assemble(copy.deepcopy(ref.index.hosts), ref.config, ref.mesh)
    np.testing.assert_array_equal(idx.indptr_g, rx.indptr_g)
    for i in range(n_shards):
        for f in ("post_doc", "post_val", "post_tf", "alive",
                  "row_start_d"):
            np.testing.assert_array_equal(
                getattr(idx, f)[i].numpy(), np.asarray(getattr(rx, f)[i]),
                f"shard {i} {f}")


# ------------------------------------------------------------ mesh guards
def test_mesh_repeats_and_collectives():
    mesh = make_mesh(4, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.distinct == (torch.device("cpu"),)
    assert make_mesh(device="cpu").size == 1
    parts = [torch.full((2, 3), i, dtype=torch.int32) for i in range(4)]
    g = port_mesh.all_gather(parts, mesh.dst)
    assert g.shape == (4, 2, 3) and (g[:, 0, 0] == torch.arange(4)).all()
    assert (port_mesh.psum(parts, mesh.dst) == 6).all()
    with pytest.raises(TypeError):
        port_mesh.psum([p.float() for p in parts], mesh.dst)
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")


def test_mesh_refuses_mixed_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="mix"):
        port_mesh.Mesh(["cpu", "cuda:0"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = make_mesh(8)
    assert [d.index for d in mesh.devices] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert make_mesh().size == 4
    assert make_mesh(3, device="cuda:1").devices == (
        torch.device("cuda", 1),) * 3


def test_sharded_engine_defaults_to_the_card(monkeypatch):
    """DistributedSearchEngine() and make_mesh() mean the card: without
    CUDA they raise, and never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistributedSearchEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_mesh.Mesh(["cuda:0"])
    eng = DistributedSearchEngine(mesh=make_mesh(2, device="cpu"))
    assert eng.scorer_mode == "xla"
    eng.scorer = "plain"
    assert eng.scorer_mode == "xla"
    eng.scorer = "fused_dv"  # the reference's sharded engine has none
    with pytest.raises(ValueError, match="unknown scorer"):
        eng.search(["x"])
