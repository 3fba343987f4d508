"""Batch scheduling: bucket queries by packed-block need.

Port of `document_search_engine_tpu/ops/schedule.py`: the planner and
the doc-range split planner, for one engine and for the sharded one
(`plan_batch_sharded`, `split_pieces_sharded`), and the packed step's
n_blocks budget (`block_plan`, `blocks_per_query`). Pure numpy, unchanged,
except that GRANULE_ROWS comes from the port's fused module.
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


def block_plan(
    indptr: np.ndarray,
    rows: np.ndarray,
    found: np.ndarray,
    block: int = 512,
) -> int:
    """Static n_blocks for a batch: max per-query sum of ceil(len/block),
    pow-2 bucketed (the n_blocks budget of packed.pack_ds)."""
    if len(indptr) < 2 or rows.size == 0:
        return 1
    lens = (indptr[rows + 1] - indptr[rows]) * found
    nblk = -(-lens // block)  # ceil
    m = int(nblk.sum(axis=1).max())
    return max(1, 1 << int(np.ceil(np.log2(max(m, 1)))))


def blocks_per_query(
    indptr: np.ndarray, rows: np.ndarray, found: np.ndarray, block: int
) -> np.ndarray:
    """(nq,) int: sum over slots of ceil(len/block)."""
    if len(indptr) < 2 or rows.size == 0:
        return np.zeros(rows.shape[0] if rows.ndim else 0, np.int64)
    lens = (indptr[rows + 1] - indptr[rows]) * found
    return (-(-lens // block)).sum(axis=1)


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


def split_pieces(
    lens: np.ndarray,  # (nq, S) per-slot postings lengths (0 = missing)
    rows: np.ndarray,  # (nq, S) term rows
    offs: np.ndarray,  # (T, P+1) host doc-quantile table (builder)
    threshold_rows: int,  # split queries needing more compacted rows
    block: int,
    p: int,  # quantile columns (builder.SPLIT_QUANTILES)
):
    """Doc-range split plan for heavy queries: a query whose compacted
    candidate need exceeds `threshold_rows` becomes m = 2^ceil(log2(
    need/threshold)) pieces (capped at p), piece i covering quantile
    columns [p*i/m, p*(i+1)/m) — doc-DISJOINT ranges, so every doc's
    integer score is complete within one piece and the per-query merge
    of piece top-ks equals the unsplit ranking exactly. Light queries
    stay one piece with columns (0, p).

    Returns (qidx (np_,), pno (np_,), cols (np_, 2), lens_p (np_, S)):
    the piece->query map, each piece's index within its query, its
    quantile columns, and its per-slot lengths from the 128-aligned
    piece range starts (what the kernel reads)."""
    need = compact_rows_per_query(lens, block)  # (nq,)
    qidx, pno, cols = _piece_structure(need, threshold_rows, p)
    lens_p = _piece_lens(lens, rows, offs, qidx, cols)
    return qidx, pno, cols, lens_p


def _piece_structure(need: np.ndarray, threshold_rows: int, p: int):
    """(qidx, pno, cols) piece table from per-query compacted need: a
    query needing more than `threshold_rows` becomes m = 2^ceil(log2(
    need/threshold)) pieces (capped at p), piece i covering quantile
    columns [p*i/m, p*(i+1)/m)."""
    nq = len(need)
    m = np.ones(nq, np.int64)
    heavy = need > threshold_rows
    if heavy.any():
        ratio = -(-need[heavy] // threshold_rows)
        mm = 1 << np.ceil(np.log2(ratio)).astype(np.int64)
        m[heavy] = np.minimum(mm, p)
    starts = np.zeros(nq + 1, np.int64)
    np.cumsum(m, out=starts[1:])
    total = int(starts[-1])
    qidx = np.repeat(np.arange(nq, dtype=np.int64), m)
    pno = (np.arange(total, dtype=np.int64) - starts[qidx]).astype(
        np.int32
    )
    mq = m[qidx]
    c0 = ((pno * p) // mq).astype(np.int32)
    c1 = (((pno + 1) * p) // mq).astype(np.int32)
    return qidx, pno, np.stack([c0, c1], axis=1)


def _piece_lens(lens, rows, offs, qidx, cols):
    """Per-slot lengths of each piece from a quantile table: the
    128-aligned piece range [align128(offs[r, c0]), offs[r, c1])."""
    rows_p = rows[qidx]
    lo = offs[rows_p, cols[:, 0:1]].astype(np.int64)
    hi = offs[rows_p, cols[:, 1:2]].astype(np.int64)
    start_al = lo - (lo % 128)
    return np.where(lens[qidx] > 0, hi - start_al, 0)


def split_pieces_sharded(
    lens_sh: np.ndarray,  # (n_shards, nq, S) per-slot lengths
    rows: np.ndarray,  # (nq, S) GLOBAL term rows
    offs_sh: np.ndarray,  # (n_shards, T_pad, P+1) per-shard quantile
    #                       tables in the global row space
    threshold_rows: int,
    block: int,
    p: int,
):
    """split_pieces for the sharded engine: the piece STRUCTURE (how
    many pieces per query, which quantile columns) is shared by every
    shard, so it is decided from the max-over-shards compacted need,
    while each shard's piece lengths come from its own quantile table
    (each shard expands its record ranges on its device; the host needs
    the lengths only for the max-over-shards block budgets).

    Returns (qidx, pno, cols, lens_p_sh (n_shards, np_, S))."""
    need = compact_rows_per_query(lens_sh, block).max(axis=0)  # (nq,)
    qidx, pno, cols = _piece_structure(need, threshold_rows, p)
    lens_p_sh = np.stack(
        [
            _piece_lens(lens_sh[i], rows, offs_sh[i], qidx, cols)
            for i in range(lens_sh.shape[0])
        ]
    )
    return qidx, pno, cols, lens_p_sh


def plan_batch(
    indptr: np.ndarray,
    rows: np.ndarray,
    found: np.ndarray,
    families=DEFAULT_FAMILIES,
    min_blocks: int = 4,
    compact: bool = False,
    lens: np.ndarray | None = None,
):
    """Mixed-block schedule: light queries use fine blocks, heavy
    queries coarse ones. Families are (total-postings threshold, block
    size), last threshold None = rest.

    Returns [(query_indices, n_blocks, block_size, r_c)] covering every
    query exactly once. r_c is the bucket's compacted candidate-buffer
    rows: with compact=True (the fused kernel) queries are sub-bucketed
    by their real granule-rounded postings need; otherwise r_c is the
    uncompacted n_blocks * block / 128.

    lens (doc-range splitting): precomputed per-slot lengths (e.g.
    split_pieces' piece lengths) override the indptr-derived ones; rows
    then index pieces, not queries.
    """
    nq = rows.shape[0]
    if len(indptr) < 2 or rows.size == 0:
        blk0 = families[0][1]
        return (
            [(np.arange(nq), 1, blk0, blk0 // 128)] if nq else []
        )
    if lens is None:
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


def plan_batch_sharded(
    lens_sh: np.ndarray,
    families=DEFAULT_FAMILIES,
    min_blocks: int = 4,
    compact: bool = False,
):
    """plan_batch for the sharded engine: the same family logic, with
    budgets max-over-shards (one plan serves every shard). lens_sh is
    (n_shards, nq, S) per-slot postings lengths (0 where missing).

    Returns [(query_indices, n_blocks, block_size, r_c)] covering every
    query exactly once; n_blocks and r_c are the max over shards of that
    bucket's need (every shard compacts into its own dstrow layout, but
    the buffer bound is shared)."""
    n_shards, nq, s = lens_sh.shape
    totals = lens_sh.sum(axis=2).max(axis=0)  # (nq,)
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
        nblk = (-(-lens_sh[:, idx_f] // blk)).sum(axis=2).max(axis=0)
        rcq = (
            compact_rows_per_query(lens_sh[:, idx_f], blk).max(axis=0)
            if compact
            else None
        )
        for sub, nb in bucket_queries(nblk, min_blocks=min_blocks):
            cap = nb * blk // 128
            if not compact:
                plans.append((idx_f[sub], nb, blk, cap))
                continue
            for sub2, rc in bucket_rows(rcq[sub], cap=cap):
                plans.append((idx_f[sub][sub2], nb, blk, rc))
    return plans
