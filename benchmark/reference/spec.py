"""Frozen copy of the fixed-point BM25 spec and the term hashing.

The parts of the program's `oracle/spec.py` and `analyze/hashing.py` that
the plain reference needs, copied so that the yardstick cannot move with
the program: f32 arithmetic in a defined operation order, round half to
even, a per-contribution clip, integer sums (DESIGN.md sections 2-3), and
FNV-1a 64 over a token's bytes.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32
FNV_OFFSET = np.uint64(0xCBF29CE484222325)
FNV_PRIME = np.uint64(0x100000001B3)


def idf_bm25(n_docs: int, df: np.ndarray) -> np.ndarray:
    """f32 ln(1 + (N - df + 0.5) / (df + 0.5)); 0 where df == 0."""
    df = np.asarray(df, dtype=F32)
    n = F32(n_docs)
    half = F32(0.5)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.log(F32(1.0) + (n - df + half) / (df + half),
                   dtype=F32).astype(F32)
    return np.where(df == F32(0.0), F32(0.0), t).astype(F32)


def avgdl(total_len: int, n_docs: int):
    return (F32(total_len) / F32(n_docs)) if n_docs else F32(0.0)


def len_coeffs(k1: float, b: float, avg):
    """c0, c1 with K(dl) = c0 + c1 * dl, in f32."""
    k1f, bf = F32(k1), F32(b)
    return k1f * (F32(1.0) - bf), (k1f * bf) / F32(avg)


def clip_max(max_query_terms: int) -> int:
    """Per-contribution clip: S_max + 1 contributions cannot overflow
    int32; a multiple of 4, so exact in f32."""
    return int(((2**31 - 1) // (max_query_terms + 1)) & ~3)


def fnv1a64(tokens: np.ndarray) -> np.ndarray:
    """FNV-1a 64 of fixed-width ASCII tokens, a (n, width) uint8 array."""
    h = np.full(tokens.shape[0], FNV_OFFSET, np.uint64)
    for j in range(tokens.shape[1]):
        h = (h ^ tokens[:, j].astype(np.uint64)) * FNV_PRIME
    return h
