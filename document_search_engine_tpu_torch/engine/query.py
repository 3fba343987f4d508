"""Host query frontend: analyze queries into padded slot arrays.

Port of `document_search_engine_tpu/engine/query.py` over the port's csr
and builder modules, and over the port's own copies of the analyzer,
hashing, native library and spec.
Per query: up to `max_query_terms` slots (unique terms sorted by hash ascending) with
the spec's coefficient A_s — the oracle's own f32 bits.
"""
from __future__ import annotations

from collections import Counter

import numpy as np

from ..index.csr import GlobalStats, lookup_sorted
from ..analyze import native
from ..analyze.hashing import TermHasher
from ..analyze.tokenizer import Tokenizer
from ..config import IndexConfig
from ..oracle import spec

F32 = np.float32


class QueryFrontend:
    def __init__(self, config: IndexConfig):
        self.config = config
        self.tokenizer = Tokenizer(config.analyzer)
        self.hasher = TermHasher()

    def _analyze_one(self, q: str, stats: GlobalStats, s: int):
        kind = self.config.scoring.kind
        toks = self.tokenizer(q)
        if not toks:
            return None
        counts = Counter(self.hasher.hash_tokens(toks).tolist())
        hashes = np.array(sorted(counts), dtype=np.uint64)
        qtf = np.array([counts[h] for h in hashes.tolist()], dtype=np.int32)
        dfs = stats.df_of(hashes)
        idf_s = spec.idf_of(kind, stats.n_alive, dfs)
        hashes, qtf, idf_s = spec.select_query_slots(hashes, qtf, idf_s, s)
        a = spec.query_coeffs(kind, qtf, idf_s)
        return hashes, a

    def analyze_slow(self, queries, stats: GlobalStats):
        """Per-query reference frontend (the spec as written): the same
        (slot_hashes, coeff) as analyze, one query at a time."""
        s = self.config.max_query_terms
        nq = len(queries)
        out_h = np.zeros((nq, s), dtype=np.uint64)
        out_a = np.zeros((nq, s), dtype=F32)
        for i, q in enumerate(queries):
            r = self._analyze_one(q, stats, s)
            if r is None:
                continue
            hashes, a = r
            out_h[i, : len(hashes)] = hashes
            out_a[i, : len(hashes)] = a
        return out_h, out_a

    def analyze(self, queries, stats: GlobalStats):
        """(slot_hashes (nq,S) uint64, coeff (nq,S) f32): analyze_rows
        without its rows and found. Empty slots have hash 0 and coeff 0."""
        out_h, out_a, _rows, _found = self.analyze_rows(queries, stats)
        return out_h, out_a

    def analyze_rows(self, queries, stats: GlobalStats):
        """(slot_hashes (nq,S) uint64, coeff (nq,S) f32, rows (nq,S)
        int32, found (nq,S) bool). Empty slots have hash 0 and coeff 0;
        rows index stats.vocab (0 where absent).

        Batched fast path: the native analyzer over all queries, then
        one C pass doing the vocab lookup, slot assembly and the
        query-side f32 coefficients in spec order. Without the native
        library the vectorized numpy path below computes the same bits.
        Queries with more unique terms than slots take the per-query
        path (slot selection is per-query logic)."""
        from ..index import builder

        s = self.config.max_query_terms
        nq = len(queries)
        if (
            nq
            and len(stats.vocab)
            and native.analyze_queries_available()
            and native.config_supported(self.config.analyzer)
        ):
            try:
                ascii_all = ("".join(queries)).isascii()
            except TypeError:
                queries = [
                    q if isinstance(q, str) else str(q) for q in queries
                ]
                ascii_all = ("".join(queries)).isascii()
            if ascii_all:
                kind = self.config.scoring.kind
                if native.hash_lookup_available():
                    table, log2n = stats.hash_table(kind)
                    out_h, out_a, out_r, out_f, overflow = (
                        native.analyze_queries_hash(
                            queries, self.config.analyzer, table,
                            log2n, s, kind,
                        )
                    )
                else:
                    vocab_c, starts, bits = stats.prefix_table()
                    out_h, out_a, out_r, out_f, overflow = (
                        native.analyze_queries(
                            queries,
                            self.config.analyzer,
                            vocab_c,
                            starts,
                            bits,
                            stats.idf_by_row(kind),
                            s,
                            kind,
                        )
                    )
                return self._finish_slow_rows(
                    queries, stats, s, np.nonzero(overflow)[0],
                    out_h, out_a, out_r, out_f,
                )
        try:
            analyzed = builder.analyze_texts_fast(queries, self.config)
        except (TypeError, AttributeError):
            queries = [q if isinstance(q, str) else str(q) for q in queries]
            analyzed = builder.analyze_texts_fast(queries, self.config)
        lens = np.diff(analyzed.doc_ptr)
        out_h = np.zeros((nq, s), dtype=np.uint64)
        out_a = np.zeros((nq, s), dtype=F32)
        out_r = np.zeros((nq, s), dtype=np.int32)
        out_f = np.zeros((nq, s), dtype=bool)
        if len(analyzed.hashes) == 0 or len(stats.vocab) == 0:
            return out_h, out_a, out_r, out_f

        kind = self.config.scoring.kind
        if native.slots_available():
            if native.hash_lookup_available():
                table, log2n = stats.hash_table(kind)
                out_h, out_a, out_r, out_f, overflow = (
                    native.query_slots_hash(
                        analyzed.hashes, analyzed.tfs,
                        analyzed.doc_ptr, table, log2n, s, kind,
                    )
                )
            else:
                vocab_c, starts, bits = stats.prefix_table()
                out_h, out_a, out_r, out_f, overflow = native.query_slots(
                    analyzed.hashes,
                    analyzed.tfs,
                    analyzed.doc_ptr,
                    vocab_c,
                    starts,
                    bits,
                    stats.idf_by_row(kind),
                    s,
                    kind,
                )
            return self._finish_slow_rows(
                queries, stats, s, np.nonzero(overflow)[0],
                out_h, out_a, out_r, out_f,
            )

        ok = lens <= s  # slot-overflow queries take the per-query path
        # the batch's active column range only; bit-exact (trailing zero
        # slots leave the spec's sequential norms unchanged)
        lmax = int(max(min(int(lens[ok].max()) if ok.any() else 1, s), 1))
        slot_idx = analyzed.doc_ptr[:-1, None] + np.arange(lmax)[None, :]
        mask = (np.arange(lmax)[None, :] < lens[:, None]) & ok[:, None]
        slot_idx = np.clip(slot_idx, 0, len(analyzed.hashes) - 1)
        h_act = np.where(mask, analyzed.hashes[slot_idx], np.uint64(0))
        qtf = np.where(mask, analyzed.tfs[slot_idx], 0).astype(np.int32)

        flat = h_act.ravel()
        idx = stats.lookup(flat)
        idx_c = np.minimum(idx, len(stats.vocab) - 1).astype(np.int64)
        fnd_flat = (stats.vocab[idx_c] == flat) & mask.ravel()
        dfs = (
            np.where(fnd_flat, stats.df[idx_c], 0)
            .astype(np.int32)
            .reshape(nq, lmax)
        )
        rows_act = (
            np.where(fnd_flat, idx_c, 0).astype(np.int32).reshape(nq, lmax)
        )
        fnd_act = fnd_flat.reshape(nq, lmax)
        idf = spec.idf_of(kind, stats.n_alive, dfs)
        qtff = qtf.astype(F32)
        if kind == "tfidf":
            qw = (qtff * idf).astype(F32)
            qnorm = np.sqrt(spec.seq_sumsq(qw, axis=1)).astype(F32)
            qnorm_safe = np.where(qnorm == F32(0.0), F32(1.0), qnorm)
            a_act = ((qw / qnorm_safe[:, None]) * idf).astype(F32)
            a_act = np.where(qnorm[:, None] == F32(0.0), F32(0.0), a_act)
        else:
            a_act = (qtff * idf).astype(F32)
        a_act = np.where(idf == F32(0.0), F32(0.0), a_act).astype(F32)
        out_h[:, :lmax] = h_act
        out_a[:, :lmax] = a_act
        out_r[:, :lmax] = rows_act
        out_f[:, :lmax] = fnd_act

        return self._finish_slow_rows(
            queries, stats, s, np.nonzero(~ok)[0],
            out_h, out_a, out_r, out_f,
        )

    def _finish_slow_rows(
        self, queries, stats, s, slow, out_h, out_a, out_r, out_f
    ):
        """Fill the slot-overflow queries via the per-query reference
        path, shared by the native and numpy batch paths."""
        for i in slow:
            out_h[i] = 0
            out_a[i] = F32(0.0)
            r = self._analyze_one(queries[i], stats, s)
            if r is None:
                continue
            hashes, a = r
            out_h[i, : len(hashes)] = hashes
            out_a[i, : len(hashes)] = a
        if len(slow):
            rows_s, found_s = segment_rows(stats.vocab, out_h[slow])
            out_r[slow] = rows_s
            out_f[slow] = found_s
        return out_h, out_a, out_r, out_f


def segment_rows(term_hash: np.ndarray, slot_hashes: np.ndarray):
    """Map slot hashes to CSR rows of one segment; (rows i32, found bool)."""
    if len(term_hash) == 0:
        z = np.zeros(slot_hashes.shape, dtype=np.int32)
        return z, np.zeros(slot_hashes.shape, dtype=bool)
    idx = lookup_sorted(term_hash, slot_hashes)
    idx_c = np.minimum(idx, len(term_hash) - 1)
    found = term_hash[idx_c] == slot_hashes
    return np.where(found, idx_c, 0).astype(np.int32), found
