"""The serving path's spans and counter (utils/prof.py, engine/engine.py)
on the CPU, through an engine that keeps step graphs under a stand-in
capturer (as tests/test_torch_step_graph.py does): every span of
search_stream lands in the Chrome trace as a user_annotation event, the
analysis on its worker thread; no record_function is entered outside a
trace; `step.pairs` equals the roofline's count of (query, posting)
pairs from each query's distinct terms and their df, unsplit and split;
`step.dead_pairs` equals a count of the tombstoned documents' postings
read from the resident planes, over device- and host-built segments;
over several segments the step merges them on the device and counts the
batch's queries in `step.device_merge_queries` and
`step.segment_merge_queries`, while `collect.merge_segments` opens once a
batch only where the host merges (the split path), never over one
segment; the registry keeps every update while several threads
write it; and chip_smoke.py's host timers still wrap the stream."""
import json
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from benchmark import roofline
from document_search_engine_tpu_torch import SearchEngine
from document_search_engine_tpu_torch.corpus.synth import (
    synth_corpus,
    synth_queries,
)
from document_search_engine_tpu_torch.engine.step_graph import (
    StepGraphs,
    add_launch_counts,
    launch_counts,
)
from document_search_engine_tpu_torch.oracle import OracleEngine
from document_search_engine_tpu_torch.utils import prof
from test_torch_merge_model import chip_smoke

torch.set_num_threads(1)

STREAM_SPANS = ("stream.analyze", "stream.wait_analysis", "dispatch.plan",
                "dispatch.enqueue", "collect.wait", "collect.assemble")


def fake_capture(step, static_in):
    """The CPU's stand-in for a CUDA graph (test_torch_step_graph.py)."""
    static_out = step(*static_in)

    def replay():
        before = launch_counts()
        static_out.copy_(step(*static_in))
        add_launch_counts(tuple(b - a for a, b in
                                zip(launch_counts(), before)))

    return replay, static_out


def _corpus(seed=3, n_docs=150):
    docs = synth_corpus(n_docs=n_docs, vocab_size=600, mean_len=30,
                        seed=seed)
    batches = [synth_queries(docs, n_queries=12, terms_per_query=4,
                             seed=seed + 1 + i) for i in range(3)]
    return docs, batches


def _graphed_engine(docs, scorer=None, split_rows=None):
    eng = SearchEngine(device="cpu")
    eng.build(docs)
    eng.scorer, eng.split_rows = scorer, split_rows
    eng._graphs = StepGraphs("cpu", capturer=fake_capture)
    return eng


def test_every_stream_span_is_in_the_trace(tmp_path):
    docs, batches = _corpus()
    eng = _graphed_engine(docs)
    list(eng.search_stream(batches, k=5))  # every graph captured
    prof.reset()
    path = tmp_path / "trace.json"
    with prof.trace(str(path)):
        got = list(eng.search_stream(batches, k=5))
    assert len(got) == len(batches)
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    by_name: dict = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    for name in STREAM_SPANS:
        assert len(by_name.get(name, ())) == len(batches), (name, by_name)
    main = {e["tid"] for e in by_name["dispatch.plan"]}
    assert len(main) == 1
    for name in STREAM_SPANS[1:]:
        assert {e["tid"] for e in by_name[name]} == main, name
    assert not {e["tid"] for e in by_name["stream.analyze"]} & main
    counts = json.loads(prof.metrics_json())["counts"]
    assert {n: counts[n] for n in STREAM_SPANS} == dict.fromkeys(
        STREAM_SPANS, len(batches))
    assert not prof._TRACING
    prof.reset()


def test_chip_smoke_host_timers_wrap_the_stream():
    """chip_smoke.py's host timers replace the engine's _dispatch and
    _collect: search_stream on a graphed engine still runs under them,
    one timed dispatch and collect a batch, and gives the same answers."""
    docs, batches = _corpus()
    eng = _graphed_engine(docs)
    want = list(eng.search_stream(batches, k=5))
    rec, restore = chip_smoke.host_timers(eng)
    try:
        got = list(eng.search_stream(batches, k=5))
    finally:
        restore()
    assert len(rec["dispatch_ms"]) == len(rec["collect_ms"]) == len(batches)
    assert len(rec["futs"]) == len(batches)
    for (g, v), (wg, wv) in zip(got, want):
        np.testing.assert_array_equal(g, wg)
        np.testing.assert_array_equal(v, wv)
    prof.reset()


def test_spans_and_pairs_are_recorded_with_graphs_only():
    """Without graphs (the CPU) a stream records no span and no count;
    with them, and reset() clears the counters too."""
    docs, batches = _corpus()
    eng = SearchEngine(device="cpu")
    eng.build(docs)
    prof.reset()
    list(eng.search_stream(batches, k=5))
    assert json.loads(prof.metrics_json()) == {
        "phases_s": {}, "counts": {}, "counters": {}}
    eng._graphs = StepGraphs("cpu", capturer=fake_capture)
    list(eng.search_stream(batches, k=5))
    assert prof.total("step.pairs") > 0
    prof.reset()
    assert prof.total("step.pairs") is None
    assert json.loads(prof.metrics_json())["counters"] == {}


class CountingSpan:
    entered = 0

    def __init__(self, name):
        assert isinstance(name, str)

    def __enter__(self):
        CountingSpan.entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_no_record_function_outside_a_trace(monkeypatch):
    docs, batches = _corpus()
    eng = _graphed_engine(docs)
    CountingSpan.entered = 0
    monkeypatch.setattr(torch.profiler, "record_function", CountingSpan)
    prof.reset()
    list(eng.search_stream(batches, k=5))
    assert CountingSpan.entered == 0
    n_blocks = sum(json.loads(prof.metrics_json())["counts"].values())
    assert n_blocks == len(STREAM_SPANS) * len(batches)
    # the control: with the trace's flag up, every block enters one
    monkeypatch.setattr(prof, "_TRACING", True)
    list(eng.search_stream(batches, k=5))
    assert CountingSpan.entered == n_blocks
    prof.reset()


def _roofline_pairs(docs, queries) -> int:
    """batch_counts' operations from each query's distinct term ids and
    df, worked out by the dict oracle."""
    oracle = OracleEngine()
    oracle.build(docs)
    ids = {h: i for i, h in enumerate(sorted(oracle.df))}
    df = np.array([oracle.df[h] for h in sorted(oracle.df)] + [0])
    terms = []
    for q in queries:
        hashes = Counter(oracle.hasher.hash_tokens(oracle.tokenizer(q))
                         .tolist())
        terms.append(np.array(sorted({ids.get(h, len(ids))
                                      for h in hashes}), np.int64))
    return roofline.batch_counts(terms, df, k=10)["ops"]


@pytest.mark.parametrize("scorer,split_rows", [
    (None, None), ("fused", None), ("fused", 2), ("fused", 4)])
def test_step_pairs_is_the_roofline_count(scorer, split_rows):
    """Over three segments (the last without a term), unsplit and with
    split_rows 2 (every real query splits) and 4 (some do), as in
    tests/test_torch_split.py."""
    docs = synth_corpus(n_docs=300, vocab_size=150, mean_len=25, seed=91)
    queries = synth_queries(docs, n_queries=10, terms_per_query=3, seed=92)
    queries += ["", "zzznotaword"]
    eng = SearchEngine(device="cpu")
    eng.build(docs[:200])
    eng.add_docs(docs[200:])
    eng.add_docs(["", "  ", ""])
    eng.scorer, eng.split_rows = scorer, split_rows
    eng._graphs = StepGraphs("cpu", capturer=fake_capture)
    want = _roofline_pairs(docs, queries)
    assert want > 0
    prof.reset()
    fut = eng._dispatch(eng.frontend.analyze_rows(queries, eng.stats), 10)
    assert prof.total("step.pairs") == want
    split = any(pm is not None and pm[2] > 1 for pm in fut[2])
    assert split == (split_rows is not None)
    eng._collect(fut)
    eng.search(queries, k=10)
    assert prof.total("step.pairs") == 2 * want
    prof.reset()


def test_the_registry_keeps_every_update_across_threads():
    """Threads on a short switch interval hammer one phase and one
    counter; a lost read-modify-write would show in the sums."""
    n_threads, n_iter = 8, 20000
    prof.reset()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_iter):
                with prof.phase("threads.x"):
                    pass
                prof.count("threads.n", 3)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rec = json.loads(prof.metrics_json())
    assert rec["counts"]["threads.x"] == n_threads * n_iter
    assert rec["counters"]["threads.n"] == 3 * n_threads * n_iter
    prof.reset()


def _streamed_engine(docs, segments, device_build=True):
    """`docs` streamed in as `segments` contiguous segments, the
    lifecycle policy off, on an engine that keeps step graphs."""
    eng = SearchEngine(device="cpu")
    eng.device_build = device_build
    eng.auto_compact_segments = eng.auto_compact_dead_frac = None
    cuts = [i * len(docs) // segments for i in range(segments + 1)]
    eng.build_streaming(docs[a:b] for a, b in zip(cuts, cuts[1:]))
    assert len(eng.segments) == segments
    eng._graphs = StepGraphs("cpu", capturer=fake_capture)
    return eng


def _row_docs(dev_seg, r):
    """Local doc ids of term row r, read from the resident doc plane."""
    flat = dev_seg.post_doc.reshape(-1).numpy()
    indptr, row_start = dev_seg.indptr.numpy(), dev_seg.row_start.numpy()
    return flat[row_start[r]: row_start[r] + indptr[r + 1] - indptr[r]]


def _dead_pairs_brute(eng, queries) -> int:
    """For each query's distinct terms and each segment that holds the
    term, the postings of its row whose document is tombstoned."""
    oracle = OracleEngine()
    n = 0
    for q in queries:
        for h in set(oracle.hasher.hash_tokens(oracle.tokenizer(q))
                     .tolist()):
            for host, dev_seg in eng.segments:
                r = int(np.searchsorted(host.term_hash, np.uint64(h)))
                if r < len(host.term_hash) and host.term_hash[r] == h:
                    n += int((~host.alive[_row_docs(dev_seg, r)]).sum())
    return n


@pytest.mark.parametrize("device_build", [True, False])
@pytest.mark.parametrize("share", [0.0, 0.1, 0.4])
@pytest.mark.parametrize("segments", [1, 3, 10])
def test_step_dead_pairs_is_the_brute_force_count(segments, share,
                                                  device_build):
    """Deleted in two calls, counted after each (the per-segment cache
    follows every mutation). The count rests on each row's length less
    its live df being its dead postings, for both build paths."""
    docs = synth_corpus(n_docs=300, vocab_size=150, mean_len=25, seed=93)
    queries = synth_queries(docs, n_queries=10, terms_per_query=3, seed=94)
    queries += ["", "zzznotaword"]
    eng = _streamed_engine(docs, segments, device_build)
    rng = np.random.default_rng(segments)
    dead = rng.choice(len(docs), size=round(share * len(docs)),
                      replace=False)
    for part in (dead[: len(dead) // 2], dead[len(dead) // 2:]):
        eng.delete_docs(part)
        for host, dev_seg in eng.segments:
            per_row = [int((~host.alive[_row_docs(dev_seg, r)]).sum())
                       for r in range(len(host.term_hash))]
            np.testing.assert_array_equal(
                np.diff(host.indptr) - host.df, per_row)
        prof.reset()
        eng.search(queries, k=10)
        want = _dead_pairs_brute(eng, queries)
        assert prof.total("step.dead_pairs") == want
        assert prof.total("step.pairs") >= want
    assert (want > 0) == (share > 0)
    prof.reset()


@pytest.mark.parametrize("segments,split_rows", [
    (1, None), (1, 2), (3, None), (3, 2)])
def test_merge_segments_opens_once_a_batch_over_segments(
        tmp_path, segments, split_rows):
    """Over several segments without split the step merges them on the
    device: the span never opens and both counters count every query.
    Split, the host merges and the span opens once a batch, inside
    collect.assemble on the main thread, with no query merged on the
    device. Over one segment neither the span nor any count; a split
    query's piece merge is never in the span."""
    docs, batches = _corpus()
    eng = _streamed_engine(docs, segments)
    eng.scorer, eng.split_rows = "fused", split_rows
    want = list(eng.search_stream(batches, k=5))  # every graph captured
    prof.reset()
    path = tmp_path / "trace.json"
    with prof.trace(str(path)):
        got = list(eng.search_stream(batches, k=5))
    for (g, v), (wg, wv) in zip(got, want):
        np.testing.assert_array_equal(g, wg)
        np.testing.assert_array_equal(v, wv)
    counts = json.loads(prof.metrics_json())["counts"]
    assert counts["collect.assemble"] == len(batches)
    host_merge = segments > 1 and split_rows is not None
    n = len(batches) if host_merge else 0
    assert counts.get("collect.merge_segments", 0) == n
    queries = sum(len(b) for b in batches)
    assert prof.total("step.segment_merge_queries") == (
        queries if segments > 1 else 0)
    assert prof.total("step.device_merge_queries") == (
        queries if segments > 1 and not host_merge else 0)
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    merges = [e for e in events if e["name"] == "collect.merge_segments"]
    assembles = [e for e in events if e["name"] == "collect.assemble"]
    assert len(merges) == n
    for m in merges:
        assert any(a["tid"] == m["tid"] and a["ts"] <= m["ts"]
                   and m["ts"] + m["dur"] <= a["ts"] + a["dur"]
                   for a in assembles)
    prof.reset()
