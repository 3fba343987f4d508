"""The cross-segment merge on the device (ops/segment_merge.py, the step's
merge branch in engine/engine.py) on the CPU: the kernel's plain mirror
against the host merge (`_merge_ranked`) over a grid of segment counts
and k, with lists shorter than k, queries absent from a segment and equal
scores across segments; which batches merge on the device; and
search_stream through the step graphs (a stand-in capturer, as
tests/test_torch_step_graph.py) over streamed, partly deleted indexes,
against the JAX package and against the host merge, ids and scores
equal."""
import functools

import numpy as np
import pytest
import torch

from document_search_engine_tpu.config import IndexConfig
from document_search_engine_tpu.engine.engine import (
    SearchEngine as RefEngine,
)
from document_search_engine_tpu_torch import SearchEngine
from document_search_engine_tpu_torch import config as port_config
from document_search_engine_tpu_torch.corpus.synth import (
    synth_corpus,
    synth_queries,
)
from document_search_engine_tpu_torch.engine import engine as E
from document_search_engine_tpu_torch.engine.step_graph import StepGraphs
from document_search_engine_tpu_torch.ops.segment_merge import (
    segment_merge,
    segment_merge_plain,
)
from document_search_engine_tpu_torch.utils import prof
from test_torch_step_graph import fake_capture

torch.set_num_threads(1)


def _ranked_lists(rng, nq, n_seg, k, gid_span=40):
    """Per (query, segment) a ranked list of up to k (score, gid) hits,
    gids disjoint across segments, scores from a few values so that
    equal scores meet across segments; (-1, -1) past the last hit.
    Returns vals, gids (nq, n_seg, k) int32 and present (nq, n_seg)."""
    vals = np.full((nq, n_seg, k), -1, np.int32)
    gids = np.full((nq, n_seg, k), -1, np.int32)
    present = rng.random((nq, n_seg)) > 0.2
    for q in range(nq):
        for si in range(n_seg):
            if not present[q, si]:
                continue
            h = int(rng.integers(0, k + 1))
            g = rng.choice(gid_span * k, size=h, replace=False)
            g = g + si * gid_span * k  # segment si's doc ids
            v = rng.integers(1, 6, size=h)
            order = np.lexsort((g, -v))
            vals[q, si, :h] = v[order]
            gids[q, si, :h] = g[order]
    return vals, gids, present


def _stack(rng, vals, gids, present):
    """The step's stacked rows in a shuffled order among junk rows (pad
    rows hold anything), and pos: each present list's row, else -1."""
    nq, n_seg, k = vals.shape
    n_rows = int(present.sum()) + 7
    stacked = rng.integers(-5, 10**6, (n_rows, 2 * k)).astype(np.int32)
    rows = rng.permutation(n_rows)
    pos = np.full((nq, n_seg), -1, np.int32)
    at = 0
    for q in range(nq):
        for si in range(n_seg):
            if present[q, si]:
                pos[q, si] = rows[at]
                stacked[rows[at]] = np.concatenate([vals[q, si], gids[q, si]])
                at += 1
    return torch.from_numpy(stacked), torch.from_numpy(pos)


@pytest.mark.parametrize("k", [1, 5, 10, 100, 128])
@pytest.mark.parametrize("n_seg", [2, 3, 10])
def test_plain_mirror_equals_the_host_merge(n_seg, k):
    rng = np.random.default_rng(1000 * n_seg + k)
    nq = 24
    vals, gids, present = _ranked_lists(rng, nq, n_seg, k)
    stacked, pos = _stack(rng, vals, gids, present)
    out = segment_merge(stacked, pos, k)
    assert out.dtype == torch.int32 and tuple(out.shape) == (nq, 2 * k)
    np.testing.assert_array_equal(
        segment_merge_plain(stacked, pos, k).numpy(), out.numpy())
    want_v, want_g = E._merge_ranked(vals.reshape(nq, n_seg * k),
                                     gids.reshape(nq, n_seg * k), k)
    np.testing.assert_array_equal(out[:, :k].numpy(), want_v)
    np.testing.assert_array_equal(out[:, k:].numpy(), want_g)


def test_equal_scores_across_segments_take_the_lower_gid_first():
    k = 3
    # segment 0 holds gids 5, 9; segment 1 holds 2, 7: all of score 4
    stacked = torch.tensor([[4, 4, -1, 5, 9, -1],
                            [4, 4, -1, 2, 7, -1]], dtype=torch.int32)
    pos = torch.tensor([[0, 1], [-1, 1], [-1, -1]], dtype=torch.int32)
    out = segment_merge(stacked, pos, k).numpy()
    np.testing.assert_array_equal(out, [[4, 4, 4, 2, 5, 7],
                                        [4, 4, -1, 2, 7, -1],
                                        [-1, -1, -1, -1, -1, -1]])


@pytest.mark.parametrize("n_segments,split,k,want", [
    (1, False, 10, False), (2, False, 10, True), (10, False, 128, True),
    (10, False, 129, False), (3, True, 10, False)])
def test_device_merges_by_what_the_batch_shows(n_segments, split, k, want):
    assert E._device_merges(n_segments, split, k) is want


def _docs(n_seg):
    docs = synth_corpus(n_docs=30 * n_seg, vocab_size=500, mean_len=25,
                        seed=n_seg)
    batches = [synth_queries(docs, n_queries=12, terms_per_query=4,
                             seed=n_seg + 1 + i) for i in range(2)]
    return docs, batches


@functools.lru_cache(maxsize=None)
def _engines(n_seg, dead_share):
    """A JAX engine and a port engine (keeping step graphs under the
    stand-in capturer, fused scorer) over the same corpus streamed in as
    n_seg segments, dead_share of its documents deleted, the lifecycle
    policy off."""
    docs, batches = _docs(n_seg)
    cuts = [i * len(docs) // n_seg for i in range(n_seg + 1)]
    dead = np.random.default_rng(n_seg).choice(
        len(docs), size=round(dead_share * len(docs)), replace=False)
    ref = RefEngine(IndexConfig())
    eng = SearchEngine(port_config.IndexConfig(), device="cpu")
    for e in (ref, eng):
        e.auto_compact_segments = e.auto_compact_dead_frac = None
        e.build_streaming(docs[a:b] for a, b in zip(cuts, cuts[1:]))
        if len(dead):
            e.delete_docs(dead)
        assert len(e.segments) == n_seg
    eng.scorer = "fused"
    eng._graphs = StepGraphs("cpu", capturer=fake_capture)
    return ref, eng, batches


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("dead_share", [0.0, 0.2])
@pytest.mark.parametrize("n_seg", [3, 10])
def test_stream_through_graphs_equals_the_jax_package_and_the_host_merge(
        monkeypatch, n_seg, dead_share, k):
    ref, eng, batches = _engines(n_seg, dead_share)
    prof.reset()
    for _ in range(2):  # a capture, then a replay
        got = list(eng.search_stream(batches, k=k))
    assert prof.total("step.device_merge_queries") == \
        prof.total("step.segment_merge_queries") == 2 * 24
    assert prof.mean_ms("collect.merge_segments") is None
    monkeypatch.setattr(E, "_device_merges", lambda *a: False)
    host = list(eng.search_stream(batches, k=k))
    assert prof.mean_ms("collect.merge_segments") is not None
    prof.reset()
    for (g, v), (hg, hv), queries in zip(got, host, batches):
        wg, wv = ref.search(queries, k=k)
        assert (v[:, 0] > 0).any()
        for ids, scores in ((g, v), (hg, hv)):
            np.testing.assert_array_equal(ids, wg)
            np.testing.assert_array_equal(scores, wv)
