"""CSR index segment structures, with torch device arrays.

Port of `document_search_engine_tpu/index/csr.py`. The host metadata
(vocabulary, df, per-doc terms, host copies of indptr/row_start) is the
reference's numpy code carried over unchanged; `SegmentDevice` holds
torch tensors in the reference's 128-aligned `(X, 128)` int32 plane
layout, so a segment built by either package carries the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if m > 1 else x


# Builders pad the posting planes to aligned_nnz + NNZ_SLICE_MARGIN so a
# block-sized read that starts inside a row never leaves the plane. Any
# packing block size must be <= this margin (asserted at the scorers).
NNZ_SLICE_MARGIN = 4096


def lookup_sorted(haystack: np.ndarray, values: np.ndarray) -> np.ndarray:
    """np.searchsorted(haystack, values), visiting the needles in sorted
    order when both sides are large (adjacent needles share cache lines
    of a cache-cold vocabulary); identical results."""
    flat = np.ascontiguousarray(values).reshape(-1)
    if len(haystack) < 500_000 or len(flat) < 4096:
        return np.searchsorted(haystack, values)
    order = np.argsort(flat, kind="stable")
    idx = np.empty(flat.shape[0], np.int64)
    idx[order] = np.searchsorted(haystack, flat[order])
    return idx.reshape(values.shape)


@dataclass
class SegmentHost:
    """Host-resident segment metadata (the reference's SegmentHost)."""

    term_hash: np.ndarray  # (T,) uint64 sorted — segment vocabulary
    df: np.ndarray  # (T,) int32 — segment-local df over alive docs
    doc_base: int  # global doc id of local doc 0
    n_docs: int  # docs in segment (unpadded; includes tombstoned)
    dl: np.ndarray  # (n_docs,) int32 doc lengths
    alive: np.ndarray  # (n_docs,) bool
    # per-doc analyzed terms: (concat sorted hashes, concat tfs, ptr)
    doc_hashes: np.ndarray = field(repr=False, default=None)
    doc_tfs: np.ndarray = field(repr=False, default=None)
    doc_ptr: np.ndarray = field(repr=False, default=None)
    # host copies of the true-prefix indptr and the aligned row starts
    # (query planning); the postings themselves stay on the device
    indptr: np.ndarray = field(repr=False, default=None)
    row_start: np.ndarray = field(repr=False, default=None)

    @property
    def n_terms(self) -> int:
        return len(self.term_hash)

    @property
    def n_alive(self) -> int:
        return int(self.alive.sum())

    @property
    def total_len_alive(self) -> int:
        return int(self.dl[self.alive].sum())


@dataclass
class SegmentDevice:
    """Device-resident CSR arrays as torch tensors.

    Postings are sorted by (term row, local doc id) and stored as
    128-record-aligned (X, 128) int32 planes: each term row starts at a
    128-aligned flat offset (`row_start`, flat index = r*128 + l), with
    sentinel-doc/zero-val padding between rows and a NNZ_SLICE_MARGIN
    tail. A 128-int32 row is one 512-byte line that a warp reads with
    16-byte loads, and the layout is the reference's bit for bit.
    """

    indptr: torch.Tensor  # (T+1,) int32 — true cumulative row lengths
    row_start: torch.Tensor  # (T,) int32 — aligned flat start per row
    post_doc: torch.Tensor  # (X, 128) int32 — doc ids, sentinel padding
    post_val: torch.Tensor  # (X, 128) int32 — bitcast f32 impact vals
    post_tf: torch.Tensor  # (X, 128) int32 — raw term frequencies
    dl: torch.Tensor  # (D_pad,) float32
    alive: torch.Tensor  # (D_pad,) bool
    inv_norm: torch.Tensor  # (D_pad,) float32 (tfidf; zeros for bm25)

    @property
    def n_docs_pad(self) -> int:
        return int(self.alive.shape[0])

    def nbytes(self) -> int:
        """Resident device bytes of this segment."""
        return sum(
            t.numel() * t.element_size()
            for t in (
                self.indptr, self.row_start, self.post_doc, self.post_val,
                self.post_tf, self.dl, self.alive, self.inv_norm,
            )
        )


@dataclass
class GlobalStats:
    """Corpus-global term statistics (merged over segments)."""

    vocab: np.ndarray  # (Tg,) uint64 sorted
    df: np.ndarray  # (Tg,) int32 — alive-doc df
    n_alive: int
    total_len_alive: int

    def lookup(self, hashes: np.ndarray) -> np.ndarray:
        """np.searchsorted(self.vocab, hashes), through the native
        prefix-table binary search when the analyzer library is built
        (identical results)."""
        from ..shared import native

        n = len(self.vocab)
        if n < 4096 or len(hashes) < 512 or not native.lookup_available():
            return lookup_sorted(self.vocab, hashes)
        vocab_c, starts, bits = self.prefix_table()
        flat = np.ascontiguousarray(hashes).reshape(-1)
        out = native.lookup_sorted_prefixed(vocab_c, starts, bits, flat)
        return out.reshape(np.shape(hashes))

    def prefix_table(self):
        """(contiguous vocab, prefix_start, bits) for the native binary
        search; built once per stats object (stats are recreated on
        every refresh, so the cache can never go stale)."""
        tbl = getattr(self, "_prefix_tbl", None)
        if tbl is None:
            n = len(self.vocab)
            bits = max(10, min(18, int(np.ceil(np.log2(max(n, 2))))))
            bounds = np.arange(1 << bits, dtype=np.uint64) << (64 - bits)
            starts = np.empty((1 << bits) + 1, np.int64)
            starts[:-1] = np.searchsorted(self.vocab, bounds)
            starts[-1] = n
            vocab_c = np.ascontiguousarray(self.vocab, dtype=np.uint64)
            tbl = (vocab_c, starts, bits)
            object.__setattr__(self, "_prefix_tbl", tbl)
        return tbl

    def hash_table(self, kind: str):
        """(table, log2n) open-addressing vocab table of (hash, row,
        idf-of-kind) for the native serving frontend, cached per kind."""
        from ..shared import native

        cache = getattr(self, "_hash_tbl", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_hash_tbl", cache)
        t = cache.get(kind)
        if t is None:
            t = cache[kind] = native.hash_build(
                self.vocab, self.idf_by_row(kind)
            )
        return t

    def idf_by_row(self, kind: str) -> np.ndarray:
        """f32 idf per vocab row (spec.idf_of over the full df array,
        computed in numpy), cached per kind."""
        from ..shared import spec

        cache = getattr(self, "_idf_by_row", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_idf_by_row", cache)
        t = cache.get(kind)
        if t is None:
            t = cache[kind] = np.ascontiguousarray(
                spec.idf_of(kind, self.n_alive, self.df)
            )
        return t

    def df_of(self, hashes: np.ndarray) -> np.ndarray:
        """df per query hash; 0 for unknown terms."""
        if len(self.vocab) == 0:
            return np.zeros(len(hashes), dtype=np.int32)
        idx = self.lookup(hashes)
        idx_c = np.minimum(idx, max(len(self.vocab) - 1, 0))
        found = self.vocab[idx_c] == hashes
        return np.where(found, self.df[idx_c], 0).astype(np.int32)


def merge_stats(segments) -> GlobalStats:
    """Merge per-segment vocab/df into corpus-global stats (host)."""
    vocabs = [s.term_hash for s in segments]
    if not vocabs:
        return GlobalStats(
            np.zeros(0, np.uint64), np.zeros(0, np.int32), 0, 0
        )
    allv = np.concatenate(vocabs)
    alld = np.concatenate([s.df for s in segments]).astype(np.int64)
    from ..shared import native

    if len(allv) >= 65536 and native.hash_lookup_available():
        vocab, inv = native.unique_inverse(allv)  # == np.unique (tested)
    else:
        vocab, inv = np.unique(allv, return_inverse=True)
    # weighted bincount; f64 weights are exact for df magnitudes
    df = np.bincount(
        inv, weights=alld.astype(np.float64), minlength=len(vocab)
    ).astype(np.int64)
    return GlobalStats(
        vocab=vocab,
        df=df.astype(np.int32),
        n_alive=sum(s.n_alive for s in segments),
        total_len_alive=sum(s.total_len_alive for s in segments),
    )
