"""Batch scheduling: bucket queries by packed-block need.

Port of `document_search_engine_tpu/ops/schedule.py` (the unsplit
planner; the doc-range split planner is ROADMAP item A11). Pure numpy,
unchanged, except that GRANULE_ROWS comes from the port's fused module.
Queries are grouped into pow-2 n_blocks buckets, each bucket runs at its
own budget, and results scatter back to their original positions.
"""
from __future__ import annotations

import numpy as np

from .fused import GRANULE_ROWS

# (threshold, block): queries whose total postings are <= threshold use
# that block size; last threshold None = rest. The plain scorer's
# families (its per-query buffer is n_blocks * block wide).
DEFAULT_FAMILIES = ((8192, 256), (None, 1024))

# The fused kernel's family: one block of 4096 (== NNZ_SLICE_MARGIN,
# the largest legal block). The kernel loads only the real rows of each
# block, so a large block costs no extra reads on this card.
FUSED_FAMILIES = ((None, 4096),)


def compact_rows_per_query(lens: np.ndarray, block: int) -> np.ndarray:
    """Compacted candidate-buffer rows per query (summed over the slot
    axis, the last one): per slot, full blocks contribute block/128 rows
    each and the tail block its granule-rounded real rows — exactly the
    space the fused kernel's dstrow compaction uses."""
    g = GRANULE_ROWS * 128
    full = lens // block
    tail = lens - full * block
    rows = full * (block // 128) + np.where(
        tail > 0, (-(-tail // g)) * GRANULE_ROWS, 0
    )
    return rows.sum(axis=-1)


def bucket_rows(rc: np.ndarray, cap: int, min_rows: int = 8):
    """Group query indices by pow-2 compacted-buffer budget in
    [min_rows, cap]. Returns [(indices, r_c)]."""
    r = np.clip(rc, 1, cap)
    exp = np.ceil(np.log2(np.maximum(r, 1))).astype(np.int64)
    exp = np.clip(
        exp, int(np.log2(min_rows)), int(np.log2(cap))
    )
    out = []
    for e in np.unique(exp):
        idx = np.nonzero(exp == e)[0]
        out.append((idx, 1 << int(e)))
    return out


def bucket_queries(nblk: np.ndarray, min_blocks: int = 4):
    """Group query indices by pow-2 block budget.

    Returns [(indices ndarray, n_blocks int)], ascending budgets; every
    query appears exactly once. Queries needing 0 blocks join the
    smallest bucket (they produce empty results anyway).
    """
    nq = len(nblk)
    if nq == 0:
        return []
    budget = np.maximum(nblk, 1)
    exp = np.ceil(np.log2(budget)).astype(np.int64)
    exp = np.maximum(exp, int(np.log2(min_blocks)))
    out = []
    for e in np.unique(exp):
        idx = np.nonzero(exp == e)[0]
        out.append((idx, 1 << int(e)))
    return out


def plan_batch(
    indptr: np.ndarray,
    rows: np.ndarray,
    found: np.ndarray,
    families=DEFAULT_FAMILIES,
    min_blocks: int = 4,
    compact: bool = False,
):
    """Mixed-block schedule: light queries use fine blocks, heavy
    queries coarse ones. Families are (total-postings threshold, block
    size), last threshold None = rest.

    Returns [(query_indices, n_blocks, block_size, r_c)] covering every
    query exactly once. r_c is the bucket's compacted candidate-buffer
    rows: with compact=True (the fused kernel) queries are sub-bucketed
    by their real granule-rounded postings need; otherwise r_c is the
    uncompacted n_blocks * block / 128.
    """
    nq = rows.shape[0]
    if len(indptr) < 2 or rows.size == 0:
        blk0 = families[0][1]
        return (
            [(np.arange(nq), 1, blk0, blk0 // 128)] if nq else []
        )
    lens = (indptr[rows + 1] - indptr[rows]) * found
    totals = lens.sum(axis=1)
    plans = []
    assigned = np.zeros(nq, bool)
    for threshold, blk in families:
        if threshold is None:
            fam = ~assigned
        else:
            fam = (totals <= threshold) & ~assigned
        assigned |= fam
        idx_f = np.nonzero(fam)[0]
        if not len(idx_f):
            continue
        nblk = (-(-lens[idx_f] // blk)).sum(axis=1)
        rcq = compact_rows_per_query(lens[idx_f], blk) if compact else None
        for sub, nb in bucket_queries(nblk, min_blocks=min_blocks):
            cap = nb * blk // 128
            if not compact:
                plans.append((idx_f[sub], nb, blk, cap))
                continue
            for sub2, rc in bucket_rows(rcq[sub], cap=cap):
                plans.append((idx_f[sub][sub2], nb, blk, rc))
    return plans
