"""A traffic mix's query pool.

The pool holds `pool_batches` batches of `batch` queries. Its shape, that
is each query's length and the rank of each of its terms, is drawn once
from the mix's `shape_seed`, so every seed runs the same set of sizes:

- lengths: raw words from the configuration's query length distribution
  (its mean is the source's), capped at `max` words; the stop ranks are
  then left out, as in the documents, and a query left with nothing keeps
  one word drawn from the remaining ranks;
- terms "corpus_frequency": each word drawn by the corpus's Zipf law,
  the only draw there is (the mix's `assumed` says why).

The run's seed then decides which token stands for each rank (the
corpus's permutation), the order in which the batches go round, and the
queries whose answers are checked.
"""
from __future__ import annotations

import numpy as np
import torch

from .corpus import seed_int, thin_stops, token_letters, zipf_cdf


def query_shapes(cfg: dict, traffic: dict, vocab: int):
    """(ranks (terms,) int64, ptr (queries + 1,) int64) of the pool."""
    if traffic["terms"] != "corpus_frequency":
        raise ValueError(f"unknown term draw {traffic['terms']!r}")
    rng = np.random.default_rng(int(traffic["shape_seed"]))
    n = int(traffic["batch"]) * int(traffic["pool_batches"])
    qcfg = cfg["queries"]
    spec = qcfg["length"]
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    sigma = float(spec["sigma"])
    mu = np.log(float(qcfg["words_mean"])) - sigma * sigma / 2
    raw = np.clip(np.rint(np.exp(rng.normal(mu, sigma, n))).astype(np.int64),
                  int(spec.get("min", 1)), int(spec["max"]))
    stop = int(cfg["vocabulary"]["stop_ranks"])
    cdf = zipf_cdf(vocab, float(cfg["vocabulary"]["zipf_s"])).numpy()
    ranks = np.minimum(
        np.searchsorted(cdf, rng.random(int(raw.sum())), side="right"),
        vocab - 1)
    stop_mass = cdf[stop - 1] if stop else 0.0
    spare = np.minimum(np.searchsorted(
        cdf, stop_mass + rng.random(n) * (1.0 - stop_mass), side="right"),
        vocab - 1)
    out, lens = thin_stops(
        torch.from_numpy(ranks), torch.repeat_interleave(
            torch.arange(n), torch.from_numpy(raw)),
        torch.from_numpy(raw), stop, torch.from_numpy(spare))
    out = out.numpy()
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens.numpy(), out=ptr[1:])
    return out, ptr


def query_texts(ranks: np.ndarray, ptr: np.ndarray, perm: np.ndarray,
                width: int) -> list:
    """Raw query texts: each query's tokens joined by one space."""
    idx = torch.from_numpy(perm[ranks])
    letters = token_letters(idx, width).numpy()
    toks = letters.view(f"S{width}").reshape(-1)
    words = [t.decode("ascii") for t in toks]
    return [" ".join(words[ptr[i]:ptr[i + 1]]) for i in range(len(ptr) - 1)]


class Pool:
    """The pool of one run: the batches' texts in pool order, the order in
    which they go round, and the sampled query positions."""

    def __init__(self, cfg: dict, traffic: dict, corpus, seed: int):
        self.batch = int(traffic["batch"])
        self.n_batches = int(traffic["pool_batches"])
        self.ranks, self.ptr = query_shapes(cfg, traffic, corpus.vocab)
        texts = query_texts(self.ranks, self.ptr, corpus.perm, corpus.width)
        b = self.batch
        self.batches = [texts[i * b:(i + 1) * b]
                        for i in range(self.n_batches)]
        rng = np.random.default_rng(seed_int(seed))
        self.order = rng.permutation(self.n_batches)
        n = b * self.n_batches
        self.sample = np.sort(rng.choice(
            n, size=min(int(traffic["sample"]), n), replace=False))

    def text(self, q: int) -> str:
        return self.batches[q // self.batch][q % self.batch]
