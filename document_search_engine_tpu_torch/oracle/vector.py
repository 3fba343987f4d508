"""Vectorized CPU oracle: the frozen reference semantics at corpus scale.

The dict-based OracleEngine (oracle.py) is deliberately shaped like the
small single-process Python engine the reference describes — but its
per-query Python postings loop caps how large parity corpora can get.
This engine produces bit-identical output (tested) from the same frozen
spec (spec.py), with the postings snapshotted into numpy CSR arrays at
refresh time and the scoring loop vectorized per query slot:
contributions are the same elementwise f32 products and round-half-even
quantization (identical bits per element), and scores are order-free
integer sums — so vectorization cannot change a single bit. This is what
lets the parity gate run at 20-Newsgroups scale (~18k docs,
BASELINE.json:8) in CI time.

The torch port's own copy of `document_search_engine_tpu/oracle/vector.py`,
kept identical in behaviour (tests/test_torch_isolation.py holds the two
against each other); the port imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np

from . import spec
from .oracle import OracleEngine

F32 = np.float32


class VectorOracleEngine(OracleEngine):
    """Drop-in OracleEngine with a vectorized scoring loop."""

    def _refresh(self) -> None:
        super()._refresh()
        # snapshot the dict index into CSR arrays (sorted by term hash)
        vocab = np.array(sorted(self.postings), dtype=np.uint64)
        counts = np.array(
            [len(self.postings[h]) for h in vocab.tolist()], np.int64
        )
        indptr = np.zeros(len(vocab) + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        nnz = int(indptr[-1])
        post_doc = np.zeros(nnz, np.int64)
        post_tf = np.zeros(nnz, np.int64)
        for i, h in enumerate(vocab.tolist()):
            plist = self.postings[h]
            docs = np.fromiter(plist.keys(), np.int64, len(plist))
            tfs = np.fromiter(plist.values(), np.int64, len(plist))
            order = np.argsort(docs)
            post_doc[indptr[i] : indptr[i + 1]] = docs[order]
            post_tf[indptr[i] : indptr[i + 1]] = tfs[order]
        self._v_vocab = vocab
        self._v_indptr = indptr
        self._v_doc = post_doc
        self._v_tf = post_tf
        n = self.next_doc_id
        self._v_alive = np.zeros(n, bool)
        for d, a in self.alive.items():
            self._v_alive[d] = a
        self._v_dl = np.zeros(n, F32)
        for d, ln in self.dl.items():
            self._v_dl[d] = F32(ln)
        if self.config.scoring.kind == "tfidf":
            self._v_inv_norm = np.zeros(n, F32)
            for d, v in self._inv_norm.items():
                if self._v_alive[d]:
                    self._v_inv_norm[d] = v

    def search(self, queries, k: int = 10):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if self._stale:
            self._refresh()
        cfg = self.config.scoring
        sb, mqt = cfg.scale_bits, self.config.max_query_terms
        n_docs = self.next_doc_id
        out_ids = np.full((len(queries), k), -1, dtype=np.int64)
        out_scores = np.full((len(queries), k), -1, dtype=np.int64)
        col = np.arange(n_docs, dtype=np.int64)
        for qi, q in enumerate(queries):
            hashes, a = self._query_slots(q)
            scores = np.zeros(n_docs, dtype=np.int64)
            rows = np.searchsorted(self._v_vocab, hashes)
            for h, a_s, r in zip(hashes.tolist(), a, rows.tolist()):
                if a_s == F32(0.0):
                    continue
                if r >= len(self._v_vocab) or self._v_vocab[r] != h:
                    continue
                s, e = self._v_indptr[r], self._v_indptr[r + 1]
                docs = self._v_doc[s:e]
                tfs = self._v_tf[s:e]
                alive = self._v_alive[docs]
                if cfg.kind == "tfidf":
                    val = spec.val_tfidf(tfs, self._v_inv_norm[docs])
                else:
                    val = spec.val_bm25(
                        tfs, self._v_dl[docs], cfg.k1, cfg.b, self._avgdl
                    )
                c = (F32(a_s) * val.astype(F32)).astype(F32)
                ci = spec.quantize_contrib(c, sb, mqt).astype(np.int64)
                np.add.at(scores, docs, np.where(alive, ci, 0))
            scores[~self._v_alive[:n_docs]] = -1
            kk = min(k, n_docs)
            order = np.lexsort((col, -scores))[:kk]
            out_ids[qi, :kk] = order
            out_scores[qi, :kk] = scores[order]
            dead = out_scores[qi] <= 0
            out_ids[qi][dead] = -1
            out_scores[qi][dead] = -1
        return out_ids, out_scores
