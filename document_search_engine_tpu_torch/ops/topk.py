"""Top-k ranking and the candidate merge of the sharded engine.

Port of `document_search_engine_tpu/ops/topk.py`: the dense reference
ranker (`topk_ranked`, and `topk_ranked_sort`, its two-key sort twin)
over ops/exact.py's dense scores, and `merge_candidates`, the shards'
ranked candidates, concatenated per query, merged into one global top-k.
Every order is (score desc, id asc). The reference's `topk_ranked`
relies on `lax.top_k` taking the lower index first among equal values;
`torch.topk` promises no order among ties, so here it only ever meets
a unique int64 key, and the sorts are stable.
"""
from __future__ import annotations

import torch


def _pad_k(vals, gids, k):
    """(vals, gids) widened to k columns with (-1, -1)."""
    nq, kk = vals.shape
    if kk < k:
        fill = torch.full((nq, k - kk), -1, dtype=vals.dtype,
                          device=vals.device)
        vals = torch.cat([vals, fill], dim=1)
        gids = torch.cat([gids, fill.to(gids.dtype)], dim=1)
    return vals, gids


def topk_ranked(
    scores: torch.Tensor,  # (nq, D) int32
    alive: torch.Tensor,  # (D,) bool
    doc_ids: torch.Tensor,  # (D,) int32 global ids of the columns,
    #                         ascending (id order == column order)
    k: int,
):
    """Top-k of dense scores: (vals (nq, k) int32, gids (nq, k) int32),
    ranked (score desc, id asc). Dead columns score -1; every slot whose
    score is not positive is (-1, -1). The key (masked score, D - 1 -
    column) is unique per row, so torch.topk's order is exact."""
    nq, d = scores.shape
    masked = torch.where(alive[None, :], scores, torch.full_like(scores, -1))
    kk = min(k, d)
    col = torch.arange(d, dtype=torch.int64, device=scores.device)
    key = masked.to(torch.int64) * (1 << 32) + (d - 1 - col)
    _top, idx = torch.topk(key, kk, dim=1)
    vals = torch.gather(masked, 1, idx)
    gids = doc_ids[idx]
    dead = vals <= 0
    gids = torch.where(dead, torch.full_like(gids, -1), gids)
    vals = torch.where(dead, torch.full_like(vals, -1), vals)
    return _pad_k(vals, gids, k)


def topk_ranked_sort(
    scores: torch.Tensor,
    alive: torch.Tensor,
    doc_ids: torch.Tensor,
    k: int,
):
    """topk_ranked by a two-key lexicographic sort on (-score, id): two
    stable sorts, the secondary key first. The same output (tested)."""
    nq, d = scores.shape
    masked = torch.where(alive[None, :], scores, torch.full_like(scores, -1))
    ids_b = doc_ids[None, :].expand(nq, d)
    _ids_s, by_id = torch.sort(ids_b, dim=1, stable=True)
    neg = torch.gather(-masked, 1, by_id)
    _neg_s, by_score = torch.sort(neg, dim=1, stable=True)
    order = torch.gather(by_id, 1, by_score)
    kk = min(k, d)
    vals = torch.gather(masked, 1, order[:, :kk])
    gids = torch.gather(ids_b, 1, order[:, :kk])
    dead = vals <= 0
    gids = torch.where(dead, torch.full_like(gids, -1), gids)
    vals = torch.where(dead, torch.full_like(vals, -1), vals)
    return _pad_k(vals, gids, k)


def merge_candidates(vals: torch.Tensor, gids: torch.Tensor, k: int):
    """(vals, gids) (nq, min(k, C)) int32 from (nq, C) int32 candidates,
    ranked (score desc, gid asc). Dead candidates (-1, -1) sort last, and
    every slot whose score is not positive comes out as (-1, -1)."""
    # -score in the high 32 bits, gid + 1 (0 .. 2^31) in the low 32: the
    # key order is the lexicographic (-score, gid) order; equal keys are
    # equal pairs, so no tie can reorder anything
    key = ((-vals.to(torch.int64)) << 32) + (gids.to(torch.int64) + 1)
    _key_s, order = torch.sort(key, dim=1, stable=True)
    kk = min(k, vals.shape[1])
    order = order[:, :kk]
    out_v = torch.gather(vals, 1, order)
    out_g = torch.gather(gids, 1, order)
    dead = out_v <= 0
    out_g = torch.where(dead, torch.full_like(out_g, -1), out_g)
    out_v = torch.where(dead, torch.full_like(out_v, -1), out_v)
    return out_v, out_g
