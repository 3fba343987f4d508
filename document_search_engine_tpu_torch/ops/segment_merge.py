"""The cross-segment merge of a batch's ranked lists (csrc/segment_merge.cu)
and its plain mirror.

Over an index of several segments the batch step (engine/engine.py
_batch_step) ranks every query's top k in each segment. This merges them
into the query's answer at the end of the step, inside its CUDA graph, so
the host reads back (nq, 2k) words a batch and merges nothing. The order
is (score desc, gid asc), which is the order of the unique composite
(v << 32) | (0x7fffffff - gid) over the live entries (v > 0): segments hold
disjoint global doc ids, so composites never tie. The JAX package merges
on the host (engine.py _merge_ranked); both give the same ids and scores.
"""
from __future__ import annotations

import torch

from .fused import MAX_K, _check_int32, _lib, check_launch


def segment_merge_plain(stacked: torch.Tensor, pos: torch.Tensor, k: int):
    """The kernel's plain mirror: int64 composites and torch.topk."""
    nq, n_seg = pos.shape
    rows = stacked.index_select(0, pos.reshape(-1).clamp(min=0).long())
    rows = rows.reshape(nq, n_seg, 2 * k).long()
    v, g = rows[..., :k], rows[..., k:]
    live = (v > 0) & (pos >= 0).unsqueeze(2)
    comp = torch.where(live, (v << 32) | (0x7FFFFFFF - g),
                       torch.zeros_like(v)).reshape(nq, n_seg * k)
    top = comp.topk(k, dim=1).values
    hit = top > 0
    vals = torch.where(hit, top >> 32, -1)
    gids = torch.where(hit, 0x7FFFFFFF - (top & 0xFFFFFFFF), -1)
    return torch.cat([vals, gids], 1).to(torch.int32)


def segment_merge(stacked: torch.Tensor, pos: torch.Tensor, k: int):
    """(nq, 2k) int32 [vals | gids]: each query's top k by (score desc,
    gid asc) over its ranked lists in the S segments, (-1, -1) past the
    last hit. stacked (rows, 2k) int32 holds ranked [vals | gids] rows;
    pos (nq, S) int32 the row of query q's list in segment si, or -1
    where the query is in none of that segment's buckets.

    CUDA tensors launch the kernel on the current stream and count one
    launch in segment_merge.launches; CPU tensors take the plain
    mirror."""
    nq, n_seg = pos.shape
    dev = stacked.device
    if dev.type == "cpu":
        return segment_merge_plain(stacked, pos, k)
    if dev.type != "cuda":
        raise ValueError(f"segment_merge: unsupported device {dev}")
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(
            f"k={k}: the merge kernel serves 1 <= k <= {MAX_K}; the engine "
            "merges larger k on the host"
        )
    _check_int32("stacked", stacked, dev)
    _check_int32("pos", pos, dev)
    if stacked.ndim != 2 or stacked.shape[1] != 2 * k:
        raise ValueError(f"stacked: expected (rows, {2 * k}), got "
                         f"{tuple(stacked.shape)}")
    out = torch.empty((nq, 2 * k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().dse_segment_merge(
            stacked.data_ptr(), pos.data_ptr(), nq, n_seg, k,
            out.data_ptr(), stream,
        )
    check_launch("segment_merge", err)
    segment_merge.launches += 1
    return out


segment_merge.launches = 0
