"""The generators: a seed repeats exactly, the draws hit the
configuration's sizes and means, the text is the ranks' rendering."""
import json

import numpy as np
import pytest
import torch

from benchmark.gen import corpus as C
from benchmark.gen.queries import Pool, query_shapes
from benchmark.reference.bm25 import parse_index
from benchmark.registry import HERE, Registry

CONFIGS = ("msmarco-passage-bm25", "beir-nq-bm25")


def config(name, docs):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg["corpus"]["docs"] = docs
    return cfg


@pytest.mark.parametrize("name", CONFIGS)
def test_corpus_repeats_for_a_seed(name):
    cfg = config(name, 3000)
    a = C.draw_corpus(cfg, 2**31 + 7, "cpu")
    b = C.draw_corpus(cfg, 2**31 + 7, "cpu")
    c = C.draw_corpus(cfg, 8, "cpu")
    assert a.texts == b.texts
    assert np.array_equal(a.ranks, b.ranks) and np.array_equal(a.lens, b.lens)
    assert not np.array_equal(a.perm, c.perm)
    assert a.texts != c.texts


@pytest.mark.parametrize("name", CONFIGS)
def test_corpus_hits_the_config(name):
    cfg = config(name, 40000)
    corp = C.draw_corpus(cfg, 3, "cpu")
    v = C.vocab_size(cfg)
    words = cfg["corpus"]["docs"] * cfg["corpus"]["doc_words_mean"]
    assert v == round(44 * words**0.49)
    assert corp.n_docs == 40000 and corp.lens.min() >= 1
    stop = cfg["vocabulary"]["stop_ranks"]
    assert corp.ranks.min() >= stop and corp.ranks.max() < v
    # analyzed tokens a document: the raw mean less the stop ranks' share
    cdf = C.zipf_cdf(v, 1.0).numpy()
    want = cfg["corpus"]["doc_words_mean"] * (1 - cdf[stop - 1])
    assert abs(corp.lens.mean() / want - 1) < 0.01
    # Zipf: rank r occurs in proportion to 1 / (r + 1)
    counts = np.bincount(corp.ranks, minlength=v)
    ratio = counts[stop] / counts[2 * stop + 1]
    assert abs(ratio / ((2 * stop + 2) / (stop + 1)) - 1) < 0.05


@pytest.mark.parametrize("name", CONFIGS)
def test_text_renders_the_ranks(name):
    corp = C.draw_corpus(config(name, 500), 5, "cpu")
    inv = np.empty_like(corp.perm)
    inv[corp.perm] = np.arange(corp.vocab)
    words = " ".join(corp.texts).split()
    assert all(len(w) == corp.width for w in words)
    assert np.array_equal(inv[parse_index(words, corp.width)], corp.ranks)
    assert [len(t.split()) for t in corp.texts] == corp.lens.tolist()


def test_lengths_hit_their_mean():
    gen = torch.Generator().manual_seed(1)
    spec = {"dist": "lognormal", "sigma": 0.42, "min": 1}
    ln = C.draw_lengths(gen, 200000, spec, 56.0, "cpu")
    assert abs(ln.double().mean().item() / 56.0 - 1) < 0.01


@pytest.mark.parametrize("traffic", ("natural-k10", "natural-k100"))
def test_pool_shapes(traffic):
    reg = Registry()
    wl = next(w for w in reg.spec["workloads"] if w["traffic"] == traffic)
    cfg = reg.config(wl["config"])
    mix = reg.traffic(traffic)
    v = C.vocab_size(cfg)
    ranks, ptr = query_shapes(cfg, mix, v)
    again, ptr2 = query_shapes(cfg, mix, v)
    assert np.array_equal(ranks, again) and np.array_equal(ptr, ptr2)
    n = mix["batch"] * mix["pool_batches"]
    lens = np.diff(ptr)
    assert len(lens) == n and lens.min() >= 1
    assert lens.max() <= cfg["queries"]["length"]["max"]
    stop = cfg["vocabulary"]["stop_ranks"]
    assert ranks.min() >= stop and ranks.max() < v
    cdf = C.zipf_cdf(v, 1.0).numpy()
    want = cfg["queries"]["words_mean"] * (1 - cdf[stop - 1])
    assert abs(lens.mean() / want - 1) < 0.03
    # drawn by corpus frequency: most terms sit in the vocabulary's head
    assert np.median(ranks) < v / 100


def test_an_unknown_term_draw_is_refused():
    reg = Registry()
    cfg = reg.config("msmarco-passage-bm25")
    mix = dict(reg.traffic("natural-k10"), terms="uniform_rows")
    with pytest.raises(ValueError, match="term draw"):
        query_shapes(cfg, mix, C.vocab_size(cfg))


def test_pool_order_and_sample_follow_the_seed():
    reg = Registry()
    cfg = config("msmarco-passage-bm25", 300)
    mix = reg.traffic("natural-k10")
    mix.update(batch=16, pool_batches=8, sample=20)
    corp = C.draw_corpus(cfg, 4, "cpu")
    a, b = Pool(cfg, mix, corp, 4), Pool(cfg, mix, corp, 4)
    c = Pool(cfg, mix, corp, 5)
    assert a.batches == b.batches and np.array_equal(a.order, b.order)
    assert np.array_equal(a.sample, b.sample)
    assert sorted(a.order) == list(range(8))
    assert not np.array_equal(a.sample, c.sample)
    assert a.text(17) == a.batches[1][1]
