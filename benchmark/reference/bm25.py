"""The plain reference: exact BM25 top-k over the drawn corpus.

Plain PyTorch and NumPy, importing nothing of the program. It takes the
corpus as the generator drew it (the ranks of each document's analyzed
tokens, of which the program's text is the fixed-width rendering) and the
raw query texts, which it parses itself. From those alone it works out
the term ids (FNV-1a classes of the tokens, so that two tokens with one
hash are one term, as for the program), df, N, avgdl, each posting's BM25
value and each (query, doc) integer score, and ranks by (score desc, doc
id asc), keeping docs with a score above 0 and padding with (-1, -1).

`alive`, where the set-up deleted documents, is the (n_docs,) bool mask
of the live ones: N is then their count, avgdl their tokens over N, df
counts live documents only, and a dead document's postings add nothing
and it is never returned (DESIGN.md section 4: a delete updates df, N
and the total length). With None every drawn document is live.

`precision` is the float type of the value and contribution arithmetic:
"float32" is the spec's, "bfloat16" the lower precision that the
correctness check's control uses. The corpus is read in blocks of
`block_tokens` tokens and the queries scored in blocks of dense rows, so
that the reference fits beside nothing else on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from . import spec

PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LETTERS = 26


def token_array(idx: np.ndarray, width: int) -> np.ndarray:
    """(n, width) uint8 letters of token indexes (base 26, most
    significant first)."""
    cols = [(idx // LETTERS**j) % LETTERS for j in range(width - 1, -1, -1)]
    return (np.stack(cols, 1) + ord("a")).astype(np.uint8)


def parse_index(words: list, width: int) -> np.ndarray:
    """Token index of each fixed-width token."""
    raw = np.frombuffer("".join(words).encode("ascii"), np.uint8)
    letters = raw.reshape(-1, width).astype(np.int64) - ord("a")
    if letters.size and (letters.min() < 0 or letters.max() >= LETTERS):
        raise ValueError("query holds a token that is not a vocabulary term")
    w = LETTERS ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return letters @ w


class Reference:
    """The reference over one drawn corpus (module docstring)."""

    def __init__(self, corpus, scoring: dict, max_query_terms: int,
                 device, alive=None, block_tokens: int = 1 << 25):
        if scoring["kind"] != "bm25":
            raise ValueError(f"the BM25 reference cannot score "
                             f"{scoring['kind']!r}")
        self.corpus = corpus
        self.k1, self.b = float(scoring["k1"]), float(scoring["b"])
        self.clip = spec.clip_max(max_query_terms)
        self.scale = float(2.0 ** int(scoring.get("scale_bits", 16)))
        self.device = torch.device(device)
        self.block_tokens = block_tokens
        v, w = corpus.vocab, corpus.width
        hashes = spec.fnv1a64(token_array(np.arange(v), w))
        _, self.cls_of_index = np.unique(hashes, return_inverse=True)
        self.n_terms = int(self.cls_of_index.max()) + 1
        self.n_docs = corpus.n_docs
        if alive is None:
            self.alive = None
            self.n_live = self.n_docs
            self.total_len = int(corpus.lens.sum())
        else:
            self.alive = np.asarray(alive, bool)
            if self.alive.shape != (self.n_docs,):
                raise ValueError(f"alive has shape {self.alive.shape}, "
                                 f"not ({self.n_docs},)")
            self.n_live = int(self.alive.sum())
            self.total_len = int(corpus.lens[self.alive].sum())

    def parse(self, text: str):
        """(terms, qtf): a query's distinct term ids and their counts."""
        words = text.split()
        if any(len(t) != self.corpus.width for t in words):
            raise ValueError(f"query {text!r}: not a fixed-width token")
        ids = self.cls_of_index[parse_index(words, self.corpus.width)]
        return np.unique(ids, return_counts=True)

    def _postings(self, wanted: np.ndarray):
        """df (n_terms,) over the live documents, and their postings of
        the wanted terms as CSR by term: (ptr, doc, tf) on the device."""
        c, dev = self.corpus, self.device
        cls_of_rank = torch.from_numpy(
            self.cls_of_index[c.perm]).to(dev)
        want = torch.from_numpy(wanted).to(dev)
        lens = torch.from_numpy(c.lens).to(dev)
        live = (None if self.alive is None
                else torch.from_numpy(self.alive).to(dev))
        ptr = np.zeros(c.n_docs + 1, np.int64)
        np.cumsum(c.lens, out=ptr[1:])
        nt = self.n_terms
        df = torch.zeros(nt, dtype=torch.int64, device=dev)
        parts = []
        d0 = 0
        while d0 < c.n_docs:
            d1 = int(np.searchsorted(ptr, ptr[d0] + self.block_tokens,
                                     side="right")) - 1
            d1 = min(max(d1, d0 + 1), c.n_docs)
            toks = torch.from_numpy(c.ranks[ptr[d0]:ptr[d1]]).to(dev)
            term = cls_of_rank[toks.long()]
            doc = torch.repeat_interleave(
                torch.arange(d1 - d0, device=dev), lens[d0:d1])
            key, _ = torch.sort(doc * nt + term)
            key, tf = torch.unique_consecutive(key, return_counts=True)
            term, doc = key % nt, key // nt + d0
            if live is not None:
                keep = live[doc]
                term, doc, tf = term[keep], doc[keep], tf[keep]
            df += torch.bincount(term, minlength=nt)
            m = want[term]
            parts.append((term[m], doc[m], tf[m]))
            d0 = d1
        term = torch.cat([p[0] for p in parts])
        order = torch.argsort(term, stable=True)
        counts = torch.bincount(term, minlength=nt)
        tptr = torch.zeros(nt + 1, dtype=torch.int64, device=dev)
        torch.cumsum(counts, 0, out=tptr[1:])
        doc = torch.cat([p[1] for p in parts])[order]
        tf = torch.cat([p[2] for p in parts])[order]
        return df.cpu().numpy(), tptr, doc, tf

    def _values(self, doc, tf, dtype):
        """BM25 value of each posting, in the spec's operation order:
        tf (k1 + 1) / (tf + (c0 + c1 dl))."""
        c0, c1 = spec.len_coeffs(self.k1, self.b,
                                 spec.avgdl(self.total_len, self.n_live))
        lens = torch.from_numpy(self.corpus.lens).to(self.device)
        tff = tf.to(dtype)
        dl = lens[doc].to(dtype)
        num = tff * float(np.float32(self.k1 + 1.0))
        den = tff + (float(c0) + float(c1) * dl)
        return num / den

    def topk(self, texts: list, k: int, precision: str = "float32"):
        """(ids, scores) int64 (len(texts), k) of each query."""
        dtype = PRECISIONS[precision]
        dev, n = self.device, self.n_docs
        parsed = [self.parse(t) for t in texts]
        wanted = np.zeros(self.n_terms, bool)
        for terms, _ in parsed:
            wanted[terms] = True
        df, tptr, pdoc, ptf = self._postings(wanted)
        val = self._values(pdoc, ptf, dtype)
        ids = np.full((len(texts), k), -1, np.int64)
        scores = np.full((len(texts), k), -1, np.int64)
        qb = max(1, min(64, (1 << 28) // max(n, 1)))
        kk = min(k, n)
        low = torch.arange(n, device=dev, dtype=torch.int64)
        low = (1 << 32) - 1 - low
        for q0 in range(0, len(texts), qb):
            block = parsed[q0:q0 + qb]
            pq, pt, pa = [], [], []
            for i, (terms, qtf) in enumerate(block):
                idf = spec.idf_bm25(self.n_live, df[terms])
                a = (qtf.astype(np.float32) * idf).astype(np.float32)
                a = np.where(idf == 0, np.float32(0), a)
                pq.append(np.full(len(terms), i))
                pt.append(terms)
                pa.append(a)
            pq = torch.from_numpy(np.concatenate(pq)).to(dev)
            pt = torch.from_numpy(np.concatenate(pt)).to(dev)
            pa = torch.from_numpy(np.concatenate(pa)).to(dev).to(dtype)
            start = tptr[pt]
            cnt = tptr[pt + 1] - start
            pair = torch.repeat_interleave(
                torch.arange(pt.numel(), device=dev), cnt)
            first = torch.cumsum(cnt, 0) - cnt
            idx = start[pair] + torch.arange(pair.numel(), device=dev) \
                - first[pair]
            c = pa[pair] * val[idx]
            ci = torch.round(c.float() * self.scale).to(torch.int64)
            ci = ci.clamp_(0, self.clip)
            dense = torch.zeros(len(block) * n, dtype=torch.int64,
                                device=dev)
            dense.index_add_(0, pq[pair] * n + pdoc[idx], ci)
            key = dense.view(len(block), n) * (1 << 32) + low
            top = torch.topk(key, kk, dim=1).values.cpu().numpy()
            sc = top >> 32
            dc = (1 << 32) - 1 - (top & 0xFFFFFFFF)
            hit = sc > 0
            rows = slice(q0, q0 + len(block))
            ids[rows, :kk] = np.where(hit, dc, -1)
            scores[rows, :kk] = np.where(hit, sc, -1)
        self.df = df
        return ids, scores
