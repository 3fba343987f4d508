"""The torch port's v2 checkpoints (CPU): a round trip after add_docs and
delete_docs; an index saved by the JAX package loads in the port and
serves the JAX engine's ids and scores with its stored plane bits (the
JAX device build's 1-ulp bm25 values on XLA:CPU are carried, not
re-derived); an index saved by the port loads in the JAX package; for
the same corpus both packages write the same files (keys, dtypes,
shapes, and every array equal but those 1-ulp plane values); the format
guards; and the plan layouts that ride in meta.json (zero grows on
replay). Each package's engine is configured with its own package's
IndexConfig.

Sharded checkpoints (DistributedSearchEngine.save/load, CPU meshes):
either package opens the other's on another shard count, both write
the same files, an elastic reshard from 4 shards to 2 and 8, a
never-built engine, and each loader refuses the other kind."""
import json
import os

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

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

KINDS = ["tfidf", "bm25"]
DEVICE_FIELDS = (
    "indptr", "row_start", "post_doc", "post_val", "post_tf", "dl",
    "alive", "inv_norm",
)
NPZ_KEYS = {
    "term_hash", "df", "doc_base", "n_docs", "dl", "alive", "doc_hashes",
    "doc_tfs", "doc_ptr", "indptr", "row_start", "plane_doc", "plane_val",
    "plane_tf", "dev_dl", "dev_alive", "dev_inv_norm",
}


def _corpus(seed=2, n=60):
    docs = synth_corpus(n_docs=n, vocab_size=400, mean_len=30, seed=seed)
    return docs, synth_queries(docs, n_queries=8, seed=seed + 1)


def _history(eng, docs):
    """build, a second segment, deletes in both segments."""
    eng.build(docs)
    eng.add_docs(docs[:5])
    eng.delete_docs([1, 7, len(docs) + 2])
    return eng


def _port(kind):
    return SearchEngine(
        port_config.IndexConfig(scoring=port_config.ScoringConfig(kind=kind)),
        device="cpu",
    )


def _ref(kind):
    return RefEngine(IndexConfig(scoring=ScoringConfig(kind=kind)))


def _assert_same(got, want, what):
    np.testing.assert_array_equal(got[0], want[0], f"{what} ids")
    np.testing.assert_array_equal(got[1], want[1], f"{what} scores")


def _npz(path, i):
    with np.load(os.path.join(path, f"segment_{i}.npz")) as z:
        return {key: z[key] for key in z.files}


@pytest.mark.parametrize("kind", KINDS)
def test_save_load_roundtrip(kind, tmp_path):
    docs, queries = _corpus()
    eng = _history(_port(kind), docs)
    want = eng.search(queries, k=10)
    path = str(tmp_path / "idx")
    eng.save(path)
    eng2 = SearchEngine.load(path, device="cpu")
    assert eng2.config.scoring.kind == kind and eng2.device.type == "cpu"
    assert eng2.n_docs_total == eng.n_docs_total == len(docs) + 5
    assert eng2.resident_bytes() == eng.resident_bytes()
    for (h, d), (h2, d2) in zip(eng.segments, eng2.segments):
        for f in DEVICE_FIELDS:  # the build's padded geometry included
            assert torch.equal(getattr(d, f), getattr(d2, f)), f
        np.testing.assert_array_equal(h.alive, h2.alive)
        np.testing.assert_array_equal(h.df, h2.df)
    _assert_same(eng2.search(queries, k=10), want, kind)
    # the loaded engine goes on living: a delete and a compact
    for e in (eng, eng2):
        e.delete_docs([3])
        e.compact()
    _assert_same(eng2.search(queries, k=10), eng.search(queries, k=10),
                 f"{kind} after delete + compact")


def test_load_defaults_to_the_card(tmp_path, monkeypatch):
    """SearchEngine.load(path) means the card: without CUDA it raises."""
    docs, _q = _corpus()
    eng = _port("bm25")
    eng.build(docs)
    eng.save(str(tmp_path / "idx"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SearchEngine.load(str(tmp_path / "idx"))


@pytest.mark.parametrize("build", ["device", "host"])
@pytest.mark.parametrize("kind", KINDS)
def test_jax_checkpoint_loads_in_port(kind, build, tmp_path):
    """The JAX engine builds (on its device path, or its host path,
    which also writes host postings that the port's SegmentHost keeps),
    adds and deletes on the CPU, then saves; the port serves its ids and
    scores from the stored plane bits."""
    docs, queries = _corpus(seed=4, n=120)
    ref = _ref(kind)
    ref.device_build = build == "device"
    ref = _history(ref, docs)
    want = ref.search(queries, k=10)
    path = str(tmp_path / "jax_idx")
    ref.save(path)
    eng = SearchEngine.load(path, device="cpu")
    assert len(eng.segments) == 2
    _assert_same(eng.search(queries, k=10), want, kind)
    _assert_same(eng.search(queries, k=40), ref.search(queries, k=40),
                 f"{kind} k=40")
    for i, (_h, d) in enumerate(eng.segments):
        z = _npz(path, i)
        for f, key in (("post_doc", "plane_doc"), ("post_val", "plane_val"),
                       ("post_tf", "plane_tf"), ("alive", "dev_alive")):
            np.testing.assert_array_equal(getattr(d, f).numpy(), z[key], f)
    if build == "host":
        # the host build's posting copies: the port's loader keeps them
        assert "post_doc" in z
        np.testing.assert_array_equal(eng.segments[-1][0].post_doc,
                                      z["post_doc"])
    if kind == "bm25" and build == "device":
        # the JAX device build's values that lie 1 ulp off the spec are
        # served as stored: the port's own history differs there
        own = _history(_port(kind), docs)
        diff = sum(int((d.post_val != o.post_val).sum())
                   for (_h, d), (_g, o) in zip(eng.segments, own.segments))
        assert diff > 0


@pytest.mark.parametrize("kind", KINDS)
def test_port_checkpoint_loads_in_jax(kind, tmp_path):
    docs, queries = _corpus(seed=6)
    eng = _history(_port(kind), docs)
    path = str(tmp_path / "port_idx")
    eng.save(path)
    ref = RefEngine.load(path)
    assert len(ref.segments) == 2 and ref.n_docs_total == eng.n_docs_total
    for k in (10, 40):
        _assert_same(ref.search(queries, k=k), eng.search(queries, k=k),
                     f"{kind} k={k}")


@pytest.mark.parametrize("kind", KINDS)
def test_both_packages_write_the_same_files(kind, tmp_path):
    """Same corpus and history: the same config.json and meta.json, and
    npz files with the same keys, dtypes and shapes, every array equal
    except plane_val, which may differ by 1 ulp on a few postings (the
    JAX device build on XLA:CPU; tests/test_torch_build.py pins where)."""
    docs, _q = _corpus(seed=8)
    p_path, r_path = str(tmp_path / "port"), str(tmp_path / "jax")
    _history(_port(kind), docs).save(p_path)
    _history(_ref(kind), docs).save(r_path)
    assert sorted(os.listdir(p_path)) == sorted(os.listdir(r_path))
    for name in ("config.json", "meta.json"):
        with open(os.path.join(p_path, name)) as f, \
                open(os.path.join(r_path, name)) as g:
            assert json.load(f) == json.load(g), name
    for i in range(2):
        got, want = _npz(p_path, i), _npz(r_path, i)
        assert set(got) == set(want) == NPZ_KEYS
        for key in NPZ_KEYS:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].shape == want[key].shape, key
            if key != "plane_val":
                np.testing.assert_array_equal(got[key], want[key], key)
        off = got["plane_val"] != want["plane_val"]
        assert np.abs(got["plane_val"][off].astype(np.int64)
                      - want["plane_val"][off]).max(initial=0) <= 1
        assert off.mean() < 0.01


def test_never_built_engine_roundtrip(tmp_path):
    """An engine that was never built saves and loads in both packages,
    and serves nothing."""
    path = str(tmp_path / "empty")
    _port("bm25").save(path)
    for eng in (SearchEngine.load(path, device="cpu"), RefEngine.load(path)):
        assert eng.segments == [] and eng.n_docs_total == 0
        ids, scores = eng.search(["anything"], k=3)
        assert (ids == -1).all() and (scores == -1).all()


@pytest.mark.parametrize("guard", ["format_version", "sharded"])
def test_checkpoint_format_guards(guard, tmp_path):
    docs, _q = _corpus()
    eng = _port("bm25")
    eng.build(docs)
    path = str(tmp_path / "idx")
    eng.save(path)
    with open(f"{path}/meta.json") as f:
        meta = json.load(f)
    if guard == "format_version":
        meta["format_version"] = 99
        match = "format_version"
    else:
        meta["sharded"] = True
        match = "DistributedSearchEngine.load"
    with open(f"{path}/meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match=match):
        SearchEngine.load(path, device="cpu")


@pytest.mark.parametrize("scorer", ["plain", "fused"])
def test_plan_layouts_persist_across_checkpoint(scorer, tmp_path):
    """Converged layouts ride in meta.json: save -> load -> replay of the
    seeding traffic gives zero layout grows, with identical results."""
    docs = synth_corpus(n_docs=250, vocab_size=700, mean_len=35, seed=17)
    eng = _port("bm25")
    eng.scorer = scorer
    eng.build(docs)
    batches = [
        synth_queries(docs, n_queries=48, seed=200 + b) for b in range(4)
    ]
    eng.preplan(batches, k=10)
    want = [eng.search(b, k=10) for b in batches]
    assert eng.plan_cache.grows >= 1
    path = str(tmp_path / "idx")
    eng.save(path)
    eng2 = SearchEngine.load(path, device="cpu")
    eng2.scorer = scorer
    assert eng2.plan_cache.grows == 0  # a restore is not growth
    for b, w in zip(batches, want):
        _assert_same(eng2.search(b, k=10), w, scorer)
    assert eng2.plan_cache.grows == 0, eng2.plan_cache.stats()
    assert eng2.plan_cache.hits >= len(batches), eng2.plan_cache.stats()


# ------------------------------------------------------ sharded checkpoints
def _sharded_history(eng, docs):
    """build, an add into the last shard, deletes in several shards."""
    eng.build(docs)
    eng.add_docs(docs[:4])
    eng.delete_docs([1, 30, len(docs) - 2])
    return eng


def _port_dist(kind, n_shards, device_build=True):
    from document_search_engine_tpu_torch import (
        DistributedSearchEngine,
        make_mesh,
    )

    eng = DistributedSearchEngine(
        port_config.IndexConfig(scoring=port_config.ScoringConfig(kind=kind)),
        mesh=make_mesh(n_shards, device="cpu"),
    )
    eng.device_build = device_build
    return eng


def _ref_dist(kind, n_shards, device_build=True):
    from document_search_engine_tpu.parallel.dist import (
        DistributedSearchEngine as RefDist,
    )
    from document_search_engine_tpu.parallel.mesh import make_mesh

    eng = RefDist(IndexConfig(scoring=ScoringConfig(kind=kind)),
                  mesh=make_mesh(n_shards))
    eng.device_build = device_build
    return eng


@pytest.mark.parametrize("build", ["device", "host"])
def test_sharded_jax_checkpoint_loads_in_port(build, tmp_path):
    """The JAX sharded engine saves at 4 shards (device-built shards
    without host postings, host-built ones with them); the port opens it
    at 2 and 4 shards and serves the JAX engine's results."""
    from document_search_engine_tpu_torch import (
        DistributedSearchEngine,
        make_mesh,
    )

    docs, queries = _corpus(seed=10, n=90)
    ref = _sharded_history(_ref_dist("bm25", 4, build == "device"), docs)
    want = ref.search(queries, k=10)
    path = str(tmp_path / "jax_sharded")
    ref.save(path)
    with np.load(os.path.join(path, "shard_0.npz")) as z:
        assert ("host_post_doc" in z.files) == (build == "host")
    for n in (2, 4):
        eng = DistributedSearchEngine.load(path,
                                           mesh=make_mesh(n, device="cpu"))
        assert eng.index.n_shards == n
        _assert_same(eng.search(queries, k=10), want, f"{build} {n}")


@pytest.mark.parametrize("build", ["device", "host"])
def test_sharded_port_checkpoint_loads_in_jax(build, tmp_path):
    from document_search_engine_tpu.parallel.dist import (
        DistributedSearchEngine as RefDist,
    )
    from document_search_engine_tpu.parallel.mesh import make_mesh

    docs, queries = _corpus(seed=12, n=90)
    eng = _sharded_history(_port_dist("tfidf", 4, build == "device"), docs)
    want = eng.search(queries, k=10)
    path = str(tmp_path / "port_sharded")
    eng.save(path)
    for n in (2, 4):
        ref = RefDist.load(path, mesh=make_mesh(n))
        _assert_same(ref.search(queries, k=10), want, f"{build} {n}")


def test_both_packages_write_the_same_sharded_files(tmp_path):
    """Same corpus and history on 4 shards: the same config.json and
    meta.json, and shard files with the same keys, dtypes and arrays."""
    docs, _q = _corpus(seed=14, n=90)
    p_path, r_path = str(tmp_path / "port"), str(tmp_path / "jax")
    _sharded_history(_port_dist("bm25", 4), docs).save(p_path)
    _sharded_history(_ref_dist("bm25", 4), docs).save(r_path)
    assert sorted(os.listdir(p_path)) == sorted(os.listdir(r_path))
    for name in ("config.json", "meta.json"):
        with open(os.path.join(p_path, name)) as f, \
                open(os.path.join(r_path, name)) as g:
            assert json.load(f) == json.load(g), name
    for i in range(4):
        with np.load(os.path.join(p_path, f"shard_{i}.npz")) as z, \
                np.load(os.path.join(r_path, f"shard_{i}.npz")) as y:
            assert set(z.files) == set(y.files)
            for key in z.files:
                assert z[key].dtype == y[key].dtype, key
                np.testing.assert_array_equal(z[key], y[key], key)


def test_sharded_checkpoint_elastic_reshard(tmp_path):
    """Saved on 4 shards, reloaded on 2, 4 and 8: the same results."""
    from document_search_engine_tpu_torch import (
        DistributedSearchEngine,
        make_mesh,
    )

    docs, queries = _corpus(seed=16, n=90)
    eng = _sharded_history(_port_dist("bm25", 4), docs)
    want = eng.search(queries, k=10)
    path = str(tmp_path / "sharded")
    eng.save(path)
    for n in (2, 4, 8):
        re = DistributedSearchEngine.load(path,
                                          mesh=make_mesh(n, device="cpu"))
        assert len(re.index.hosts) == n
        _assert_same(re.search(queries, k=10), want, f"{n} shards")


def test_sharded_checkpoint_empty_engine(tmp_path):
    """A never-built sharded engine saves and reloads on any mesh to an
    empty engine."""
    from document_search_engine_tpu_torch import (
        DistributedSearchEngine,
        make_mesh,
    )

    path = str(tmp_path / "empty")
    _port_dist("bm25", 4).save(path)
    re = DistributedSearchEngine.load(path, mesh=make_mesh(2, device="cpu"))
    assert re.index is None
    ids, sc = re.search(["anything"], k=5)
    assert (ids == -1).all() and (sc == -1).all()


def test_each_loader_refuses_the_other_kind(tmp_path):
    """SearchEngine.load refuses a sharded checkpoint with the
    reference's error, and DistributedSearchEngine.load a single one."""
    from document_search_engine_tpu_torch import (
        DistributedSearchEngine,
        make_mesh,
    )

    docs, _q = _corpus()
    sharded = str(tmp_path / "sharded")
    _port_dist("bm25", 2).save(sharded)
    with pytest.raises(ValueError, match="DistributedSearchEngine.load"):
        SearchEngine.load(sharded, device="cpu")
    single = str(tmp_path / "single")
    eng = _port("bm25")
    eng.build(docs)
    eng.save(single)
    with pytest.raises(ValueError, match="not a sharded checkpoint"):
        DistributedSearchEngine.load(single, mesh=make_mesh(2, device="cpu"))
