"""A deployment's corpus, drawn from the seed on the device.

The vocabulary has V terms, V from Heaps' law over the corpus's raw words
(Manning, Raghavan and Schuetze, Introduction to IR, section 5.1.1: V = K
T^beta). Term occurrences are Zipf with exponent s over the V ranks (rank 0
the most frequent). The `stop_ranks` head ranks stand for the stop list
that the source's analyzer removes: they are drawn and then left out, so
the text is the analyzed token stream. A document that loses every word
to the stop list keeps one word drawn from the remaining ranks.

Each term is a fixed-width ASCII token of lowercase letters (the base-26
digits of its token index, most significant first). Which token stands
for which rank is a permutation drawn from the seed, so two seeds give the
same frequencies to different strings.

Everything is drawn from one `torch.Generator` on the device, in chunks
of CHUNK_DOCS documents: the same seed on the same device gives the same
corpus.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

CHUNK_DOCS = 1 << 20
LETTERS = 26
SEED_MASK = (1 << 63) - 1


def seed_int(seed: int) -> int:
    """The seed as a generator seed: any whole number, folded into 63
    bits."""
    return abs(int(seed)) & SEED_MASK


def vocab_size(cfg: dict) -> int:
    """V = K * T^beta over the raw words T = docs * mean words a doc."""
    voc, corp = cfg["vocabulary"], cfg["corpus"]
    words = corp["docs"] * corp["doc_words_mean"]
    return int(round(voc["heaps_k"] * words ** voc["heaps_beta"]))


def token_width(v: int) -> int:
    """Letters a token needs so that V tokens are distinct."""
    w = 1
    while LETTERS**w < v:
        w += 1
    return w


def zipf_cdf(v: int, s: float, device="cpu") -> torch.Tensor:
    """float64 CDF over ranks 0..V-1 with P(rank r) proportional to
    (r + 1)^-s."""
    p = torch.arange(1, v + 1, dtype=torch.float64, device=device) ** -s
    cdf = torch.cumsum(p, 0)
    return cdf / cdf[-1]


def draw_ranks(gen, cdf: torch.Tensor, n: int, lo: float = 0.0):
    """n ranks by inverse CDF from uniforms in [lo, 1) (lo = the mass of
    the ranks to skip)."""
    u = torch.rand(n, generator=gen, device=cdf.device, dtype=torch.float64)
    if lo:
        u = lo + u * (1.0 - lo)
    r = torch.searchsorted(cdf, u, right=True)
    return r.clamp_(max=cdf.numel() - 1)


def draw_lengths(gen, n: int, spec: dict, mean: float, device):
    """n lengths from the named distribution with the given mean: for
    "lognormal", round(exp(N(mu, sigma))) with mu = ln(mean) - sigma^2/2,
    clipped to [min, max]."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    sigma = float(spec["sigma"])
    mu = math.log(mean) - sigma * sigma / 2
    z = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
    ln = torch.round(torch.exp(mu + sigma * z)).to(torch.int64)
    return ln.clamp_(int(spec.get("min", 1)), int(spec.get("max", 1 << 20)))


def thin_stops(ranks, doc, lens, stop: int, spare):
    """Drops the stop ranks of a ragged token array (document `doc` of
    each token, `lens` tokens a document); a document left with nothing
    takes its `spare` rank. Returns (ranks, lengths) in document order."""
    nd = lens.numel()
    keep = ranks >= stop
    kept_doc = doc[keep]
    kept = torch.bincount(kept_doc, minlength=nd)
    empty = kept == 0
    new_len = kept + empty.to(torch.int64)
    new_off = torch.cumsum(new_len, 0) - new_len
    kept_off = torch.cumsum(kept, 0) - kept
    out = torch.empty(int(new_len.sum()), dtype=ranks.dtype,
                      device=ranks.device)
    pos = torch.arange(kept_doc.numel(), device=ranks.device)
    out[pos - kept_off[kept_doc] + new_off[kept_doc]] = ranks[keep]
    out[new_off[empty]] = spare[empty]
    return out, new_len


def token_letters(idx: torch.Tensor, width: int) -> torch.Tensor:
    """(n, width) uint8 lowercase letters of token indexes."""
    cols = []
    for j in range(width - 1, -1, -1):
        cols.append((idx // LETTERS**j) % LETTERS)
    return (torch.stack(cols, 1) + ord("a")).to(torch.uint8)


def render(ranks: torch.Tensor, lens: torch.Tensor, perm: torch.Tensor,
           width: int) -> list:
    """Texts of documents given as ragged ranks: tokens joined by one
    space. Rendered on the ranks' device into one buffer, one '\\n' after
    each document, then split on the host."""
    n = ranks.numel()
    buf = torch.full((n, width + 1), ord(" "), dtype=torch.uint8,
                     device=ranks.device)
    buf[:, :width] = token_letters(perm[ranks], width)
    ends = torch.cumsum(lens, 0) - 1
    buf[ends, width] = ord("\n")
    text = buf.reshape(-1).cpu().numpy().tobytes().decode("ascii")
    return text.split("\n")[:-1]


@dataclass
class Corpus:
    """A drawn corpus: texts (what the program builds from), and the same
    documents as ranks for the plain reference."""

    texts: list  # n_docs strings
    ranks: np.ndarray  # (tokens,) int32 analyzed ranks, document order
    lens: np.ndarray  # (n_docs,) int64 analyzed tokens a document
    perm: np.ndarray  # (V,) int64 token index of each rank
    vocab: int
    width: int

    @property
    def n_docs(self) -> int:
        return len(self.lens)


def draw_corpus(cfg: dict, seed: int, device, texts: bool = True) -> Corpus:
    """The configuration's corpus for `seed` (module docstring). With
    texts=False only the ranks are drawn (the reference's controls)."""
    v = vocab_size(cfg)
    width = token_width(v)
    voc, corp = cfg["vocabulary"], cfg["corpus"]
    stop = int(voc["stop_ranks"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_int(seed))
    perm = torch.randperm(v, generator=gen, device=device)
    cdf = zipf_cdf(v, float(voc["zipf_s"]), device)
    stop_mass = float(cdf[stop - 1]) if stop else 0.0
    n = int(corp["docs"])
    out_texts, out_ranks, out_lens = [], [], []
    for d0 in range(0, n, CHUNK_DOCS):
        nd = min(CHUNK_DOCS, n - d0)
        raw = draw_lengths(gen, nd, corp["doc_length"],
                           float(corp["doc_words_mean"]), device)
        ranks = draw_ranks(gen, cdf, int(raw.sum()))
        spare = draw_ranks(gen, cdf, nd, stop_mass)
        doc = torch.repeat_interleave(
            torch.arange(nd, device=device), raw)
        ranks, lens = thin_stops(ranks, doc, raw, stop, spare)
        if texts:
            out_texts.extend(render(ranks, lens, perm, width))
        out_ranks.append(ranks.to(torch.int32).cpu().numpy())
        out_lens.append(lens.cpu().numpy())
    return Corpus(
        texts=out_texts,
        ranks=np.concatenate(out_ranks),
        lens=np.concatenate(out_lens),
        perm=perm.cpu().numpy(),
        vocab=v,
        width=width,
    )
