"""The candidate merge of the sharded engine.

Port of `document_search_engine_tpu/ops/topk.py merge_candidates`: the
shards' ranked candidates, concatenated per query, merged into one
global top-k in the same order, (score desc, gid asc). The reference
sorts on the two keys (-score, gid); here they are one composite int64
key under a stable sort. torch.topk is not used: it promises no order
among ties.
"""
from __future__ import annotations

import torch


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
