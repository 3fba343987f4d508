"""Dense reference scorer: a slot-by-slot scan over the CSR index.

Port of `document_search_engine_tpu/ops/exact.py` (`row_cap`,
`score_exact`), the bit-exact reference that the packed pipeline
(ops/packed.py) is held against. For each query slot (one unique query
term) the term's CSR postings row is gathered, each contribution is
quantized to int32 fixed point (DESIGN.md §2), and the contributions are
added into dense per-query scores. Within a slot a (query, doc) pair
gets at most one contribution, and across slots the sums are integer,
so every execution order gives the same bits: the integer scatter-add
may run in any order on the card.

It is a plain PyTorch reference, with no kernel of its own, and it
quantizes as the packed scorers do (packed.quantize): one f32 multiply
A_s * val, one by 2^bits, round half to even, clip, int32.
"""
from __future__ import annotations

import numpy as np
import torch

from .packed import quantize


def row_cap(indptr: np.ndarray, rows: np.ndarray) -> int:
    """Gather capacity for a batch: max row length, pow-2 bucketed."""
    if rows.size == 0:
        return 8
    lens = indptr[rows + 1] - indptr[rows]
    m = int(lens.max()) if lens.size else 0
    return max(8, 1 << int(np.ceil(np.log2(max(m, 1)))))


def score_exact(
    indptr: torch.Tensor,  # (T+1,) int32
    post_doc: torch.Tensor,  # (nnz,) int32, indptr-contiguous rows
    post_val: torch.Tensor,  # (nnz,) f32
    rows: torch.Tensor,  # (nq, S) int32 — CSR row per slot (0 if missing)
    coeff: torch.Tensor,  # (nq, S) f32 — A_s per slot (0 if missing)
    scale: float,  # f32(2^scale_bits) as a Python float
    clip: float,  # f32 per-contribution clip as a Python float
    cap: int,  # >= the longest row a slot gathers (row_cap)
    n_docs_pad: int,
) -> torch.Tensor:
    """Dense int32 scores (nq, n_docs_pad). Masked lanes add 0 to the
    last pad column; a doc id >= n_docs_pad is dropped, as the
    reference's scatter drops it."""
    nq, s = rows.shape
    dev = post_doc.device
    ip = indptr.to(torch.int64)
    offs = torch.arange(cap, dtype=torch.int64, device=dev)[None, :]
    last = max(int(post_doc.numel()) - 1, 0)
    scores = torch.zeros((nq, n_docs_pad), dtype=torch.int32, device=dev)
    if post_doc.numel() == 0:
        return scores
    for j in range(s):
        r = rows[:, j].to(torch.int64)
        a = coeff[:, j]
        start = ip[r]
        length = ip[r + 1] - start
        mask = offs < length[:, None]  # (nq, cap)
        # masked lanes read the row's start, clamped into the arrays
        idx = (start[:, None] + torch.where(mask, offs, 0)).clamp(0, last)
        d = post_doc[idx].to(torch.int64)
        keep = mask & (d < n_docs_pad)
        ci = quantize(a[:, None], post_val[idx], scale, clip, keep)
        d = torch.where(keep, d, torch.full_like(d, n_docs_pad - 1))
        scores.scatter_add_(1, d, ci)
    return scores
