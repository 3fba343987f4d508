"""The compiled batch step (engine/step_graph.py) on the CPU, where no
CUDA graph can be captured: StepGraphs driven by an injected capturer
that stands in for the graph (it keeps one static output and rewrites it
from the static inputs on every replay, and a replay runs no Python that
counts launches). One capture a key and a replay for every later batch;
a new key for each static argument and input shape; fresh outputs that
stay right while 8 are held; the launch counters; a failing capture;
the engines dropping their graphs on every mutation and on a layout
grow; and CPU engines serving through the graphs with the JAX package's
and the oracle's results."""
import json

import numpy as np
import pytest
import torch

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.corpus.synth import synth_corpus, synth_queries
from document_search_engine_tpu.engine.engine import (
    SearchEngine as RefEngine,
)
from document_search_engine_tpu.oracle import OracleEngine
from document_search_engine_tpu_torch import (
    DistributedSearchEngine,
    SearchEngine,
    make_mesh,
)
from document_search_engine_tpu_torch import config as port_config
from document_search_engine_tpu_torch.engine.step_graph import (
    StepGraphs,
    add_launch_counts,
    launch_counts,
    resident_key,
    step_key,
)
from document_search_engine_tpu_torch.ops.fused import fused_search
from document_search_engine_tpu_torch.ops.rank import rank_kernel
from document_search_engine_tpu_torch.utils import prof

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)


def fake_capture(step, static_in):
    """The CPU's stand-in for a CUDA graph: the step's output is the
    static output, and a replay rewrites it in place from the static
    inputs' current contents without counting a launch."""
    static_out = step(*static_in)

    def replay():
        before = launch_counts()
        static_out.copy_(step(*static_in))
        add_launch_counts(tuple(b - a for a, b in
                                zip(launch_counts(), before)))

    return replay, static_out


def _graphs():
    return StepGraphs("cpu", capturer=fake_capture)


def _toy_step(a, b):
    return a * 3 + b.sum(dim=1, keepdim=True)


def _inputs(seed, n=6):
    rng = np.random.default_rng(seed)
    return (rng.integers(-50, 50, (n, 4)).astype(np.int32),
            rng.integers(-50, 50, (n, 4)).astype(np.int32))


def _eager(inputs):
    return _toy_step(*(torch.from_numpy(a) for a in inputs))


def _key(inputs, **over):
    kw = dict(plan=((100, 4, ((8, 512, 16, 16),)),), k=10, scale=65536.0,
              clip=1e6, mode="fused", n_real=6, split_p=0)
    kw.update(over)
    return step_key(inputs=inputs, **kw)


def test_one_capture_per_key_then_a_replay_for_every_batch():
    g = _graphs()
    for seed in range(5):
        ins = _inputs(seed)
        out = g.run("slot", _key(ins), _toy_step, ins)
        assert torch.equal(out, _eager(ins))
    assert (g.captures, g.replays, len(g)) == (1, 4, 1)
    assert len(g.capture_ms) == 1


@pytest.mark.parametrize("field", ["plan", "k", "mode", "n_real", "split_p",
                                   "merge", "shape"])
def test_a_new_key_when_a_static_argument_or_shape_differs(field):
    g = _graphs()
    ins = _inputs(0)
    g.run("slot", _key(ins), _toy_step, ins)
    g.run("slot", _key(ins), _toy_step, ins)
    changed = {"plan": dict(plan=((100, 4, ((16, 512, 16, 32),)),)),
               "k": dict(k=64), "mode": dict(mode="xla_rank"),
               "n_real": dict(n_real=7), "split_p": dict(split_p=16),
               "merge": dict(merge=True)}
    if field == "shape":
        ins2, key2 = _inputs(1, n=7), _key(_inputs(1, n=7))
    else:
        ins2, key2 = ins, _key(ins, **changed[field])
    assert key2 != _key(ins)
    out = g.run("slot", key2, _toy_step, ins2)
    assert torch.equal(out, _eager(ins2))
    assert (g.captures, g.replays) == (2, 1)
    # any other difference replaces the slot's graphs (a layout grow);
    # n_real alone (and the rows' tail with it) keeps both, as the JAX
    # package keeps both programs
    assert len(g) == (2 if field in ("n_real", "shape") else 1)


def test_replays_return_distinct_tensors_that_stay_right():
    """8 outputs held at once (8 batches in flight) each equal the eager
    step on their own inputs: every replay copies the static output
    out."""
    g = _graphs()
    batches = [_inputs(seed) for seed in range(9)]
    key = _key(batches[0])
    g.run("slot", key, _toy_step, batches[0])
    outs = [g.run("slot", key, _toy_step, ins) for ins in batches[1:]]
    assert g.replays == 8
    assert len({o.data_ptr() for o in outs}) == 8
    for o, ins in zip(outs, batches[1:]):
        assert torch.equal(o, _eager(ins))
    # the replayer runs the last batch again into a fresh tensor
    again = g.replayer()()
    assert torch.equal(again, outs[-1]) and again.data_ptr() != \
        outs[-1].data_ptr()


def test_launch_counters_advance_by_the_captured_counts():
    def counting_step(a, b):
        fused_search.launches += 3
        rank_kernel.launches += 1
        return _toy_step(a, b)

    g = _graphs()
    ins = _inputs(0)
    c0 = launch_counts()
    g.run("slot", _key(ins), counting_step, ins)
    # the warm-up launched for real; the capture launched nothing
    assert fused_search.launches - c0[0] == 3
    assert rank_kernel.launches - c0[4] == 1
    for i in range(1, 4):
        g.run("slot", _key(ins), counting_step, _inputs(i))
    assert fused_search.launches - c0[0] == 12
    assert rank_kernel.launches - c0[4] == 4
    assert launch_counts()[1:4] == c0[1:4]


def test_an_error_at_capture_propagates():
    def refusing(step, static_in):
        raise RuntimeError("operation not permitted when stream is capturing")

    g = StepGraphs("cpu", capturer=refusing)
    ins = _inputs(0)
    for _ in range(2):  # no graph is kept, and no eager retry answers
        with pytest.raises(RuntimeError, match="capturing"):
            g.run("slot", _key(ins), _toy_step, ins)
    assert (len(g), g.captures, g.replays) == (0, 0, 0)


def test_resident_tensors_are_part_of_the_key():
    """A plane the graph was not captured on is a new key, which
    replaces the slot's graphs."""
    g = _graphs()
    ins = _inputs(0)
    plane = torch.zeros(8, 128, dtype=torch.int32)
    g.run("slot", _key(ins, resident=resident_key([plane], [0])), _toy_step,
          ins)
    other = torch.zeros(8, 128, dtype=torch.int32)
    assert resident_key([other], [0]) != resident_key([plane], [0])
    assert resident_key([plane], [5]) != resident_key([plane], [0])
    g.run("slot", _key(ins, resident=resident_key([other], [0])), _toy_step,
          ins)
    assert (g.captures, len(g)) == (2, 1)


# ---------------------------------------------------------------- engines
def _toy(seed=0, n_docs=120):
    docs = synth_corpus(n_docs=n_docs, vocab_size=800, mean_len=40, seed=seed)
    queries = synth_queries(docs, n_queries=17, terms_per_query=5,
                            seed=seed + 1)
    queries += ["", "zzznotaword", docs[0].split()[0]]
    return docs, queries


def _port_cfg(cfg):
    return port_config.IndexConfig.from_json(cfg.to_json())


def _graphed(eng):
    eng._graphs = _graphs()
    return eng


def _assert_same(got, want, what):
    np.testing.assert_array_equal(got[0], want[0], f"{what} ids")
    np.testing.assert_array_equal(got[1], want[1], f"{what} scores")


@pytest.mark.parametrize("mutation", ["add_docs", "delete_docs", "compact",
                                      "load"])
def test_every_mutation_drops_the_graphs(mutation, tmp_path):
    docs, queries = _toy(seed=3, n_docs=90)
    eng = _graphed(SearchEngine(device="cpu"))
    eng.scorer = "fused"
    eng.build(docs[:60])
    eng.add_docs(docs[60:])
    eng.search(queries, k=10)
    eng.search(queries, k=10)
    assert len(eng._graphs) == 1 and eng._graphs.replays == 1
    assert eng._last_step is not None
    if mutation == "add_docs":
        eng.add_docs(["a brand new doc about nothing"])
    elif mutation == "delete_docs":
        eng.delete_docs([0, 5, 70])
    elif mutation == "compact":
        eng.compact()
    else:
        eng.save(str(tmp_path))
        loaded = SearchEngine.load(str(tmp_path), device="cpu")
        eng.load_segments(loaded.segments)
    assert len(eng._graphs) == 0 and eng._last_step is None
    ora = OracleEngine()
    ora.build(docs[:60])
    ora.add_docs(docs[60:])
    if mutation == "add_docs":
        ora.add_docs(["a brand new doc about nothing"])
    elif mutation == "delete_docs":
        ora.delete_docs([0, 5, 70])
    _assert_same(eng.search(queries, k=10), ora.search(queries, k=10),
                 mutation)
    assert len(eng._graphs) == 1


@pytest.mark.parametrize("mutation", ["add_docs", "delete_docs", "compact"])
def test_every_sharded_mutation_drops_the_graphs(mutation):
    docs, queries = _toy(seed=6, n_docs=80)
    eng = _graphed(DistributedSearchEngine(mesh=make_mesh(2, device="cpu")))
    eng.scorer = "fused"
    eng.build(docs)
    eng.search(queries, k=10)
    assert len(eng._graphs) == 1
    getattr(eng, mutation)(*{"add_docs": (["one more doc"],),
                             "delete_docs": ([1, 2, 40],),
                             "compact": ()}[mutation])
    assert len(eng._graphs) == 0 and eng._last_step is None
    eng.search(queries, k=10)
    assert len(eng._graphs) == 1


def test_a_layout_grow_releases_the_old_graph():
    docs, queries = _toy(seed=7, n_docs=200)
    eng = _graphed(SearchEngine(device="cpu"))
    eng.scorer = "fused"
    eng.build(docs)
    eng.search(queries[:4], k=10)
    grows = eng.plan_cache.grows
    assert len(eng._graphs) == 1
    # 40 more queries do not fit the 4-query layout: it grows
    big = queries * 3
    eng.search(big, k=10)
    assert eng.plan_cache.grows > grows
    assert eng._graphs.captures == 2 and len(eng._graphs) == 1
    # the same traffic fits the grown layout: a replay
    eng.search(big[::-1], k=10)
    assert eng._graphs.replays == 1 and len(eng._graphs) == 1


@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_engine_through_graphs_equals_the_jax_package(kind):
    """Each scorer path and k through the graph path (capture, then
    replays of the same keys) equals the JAX engine and the oracle;
    search_stream at depth 8 too."""
    docs, queries = _toy(seed=1)
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    ref = RefEngine(cfg)
    ref.build(docs[:80])
    ref.add_docs(docs[80:])
    ora = OracleEngine(cfg)
    ora.build(docs)
    eng = _graphed(SearchEngine(_port_cfg(cfg), device="cpu"))
    eng.build(docs[:80])
    eng.add_docs(docs[80:])
    for scorer, split in (("fused", None), ("fused_dv", None),
                          ("xla_rank", None), ("fused", 1), ("plain", None)):
        eng.scorer, eng.split_rows = scorer, split
        for k in (1, 10, 64, 200):
            want = ora.search(queries, k=k)
            for _ in range(2):  # a capture, then a replay
                _assert_same(eng.search(queries, k=k), want,
                             f"{kind} {scorer} {split} k={k}")
    _assert_same(ref.search(queries, k=10), ora.search(queries, k=10),
                 "reference")
    assert eng._graphs.replays >= 20
    eng.scorer, eng.split_rows = None, None
    batches = [queries[:5], queries[5:11], queries[11:]]
    got = list(eng.search_stream(batches * 3, k=10, depth=8))
    want = ref.search(queries, k=10)
    for i in range(3):
        _assert_same(
            (np.concatenate([g[0] for g in got[3 * i : 3 * i + 3]]),
             np.concatenate([g[1] for g in got[3 * i : 3 * i + 3]])),
            want, f"{kind} stream pass {i}")


def test_sharded_engine_through_graphs_equals_the_jax_package():
    docs, queries = _toy(seed=2)
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    ref = RefEngine(cfg)
    ref.build(docs)
    want = ref.search(queries, k=10)
    for n in (1, 2, 4):
        eng = _graphed(DistributedSearchEngine(
            _port_cfg(cfg), mesh=make_mesh(n, device="cpu")))
        eng.build(docs)
        for scorer, split in (("fused", None), ("xla_rank", None),
                              ("fused", 1)):
            eng.scorer, eng.split_rows = scorer, split
            for _ in range(2):
                _assert_same(eng.search(queries, k=10), want,
                             f"{n} shards {scorer} {split}")
        assert eng._graphs.replays >= 3


def test_split_gather_rounds_to_256_and_the_replayer_reruns_the_batch():
    docs, queries = _toy(seed=4)
    eng = _graphed(SearchEngine(device="cpu"))
    eng.build(docs)
    eng.scorer, eng.split_rows = "fused", 1
    fut = eng._dispatch(eng.frontend.analyze_rows(queries, eng.stats), 10)
    out = fut[0]
    n_pieces = sum(len(idx) for idxs in fut[1] for idx, _bq in idxs)
    assert out.shape[0] == -(-n_pieces // 256) * 256 > n_pieces
    again = eng._step_replayer()()
    assert torch.equal(again, out)
    np.testing.assert_array_equal(eng._collect((again, *fut[1:]))[0],
                                  eng._collect(fut)[0])


def test_dispatch_records_plan_and_enqueue_with_graphs_only():
    docs, queries = _toy(seed=5, n_docs=40)
    eng = SearchEngine(device="cpu")
    eng.build(docs)
    prof.reset()
    eng.search(queries, k=5)
    assert set(json.loads(prof.metrics_json())["counts"]) == {
        "search.analyze", "search.score"}
    _graphed(eng)
    prof.reset()
    eng.search(queries, k=5)
    assert json.loads(prof.metrics_json())["counts"] == {
        "search.analyze": 1, "search.score": 1, "dispatch.plan": 1,
        "dispatch.enqueue": 1, "collect.wait": 1, "collect.assemble": 1}
    prof.reset()


def test_card_capture_frees_the_idle_cache_first(monkeypatch):
    """cuda_capture, as torch.cuda.graph does on entering, waits for the
    card and empties the allocator's cache before the capture begins
    (the allocator cannot release cached blocks during a capture), and
    ends the capture when the step raises."""
    from document_search_engine_tpu_torch.engine import step_graph

    calls = []

    class FakeGraph:
        def capture_begin(self, pool=None):
            calls.append(("capture_begin", pool))

        def capture_end(self):
            calls.append(("capture_end",))

        def replay(self):
            calls.append(("replay",))

    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(("synchronize",)))
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: calls.append(("empty_cache",)))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    capture = step_graph.cuda_capture(("pool", 1))
    x = torch.arange(4)
    replay, out = capture(lambda t: t * 2, (x,))
    assert torch.equal(out, x * 2)
    assert calls == [("synchronize",), ("empty_cache",),
                     ("capture_begin", ("pool", 1)), ("capture_end",)]
    replay()
    assert calls[-1] == ("replay",)
    calls.clear()

    def failing(t):
        raise RuntimeError("no capture")

    with pytest.raises(RuntimeError, match="no capture"):
        capture(failing, (x,))
    assert calls[-1] == ("capture_end",)
