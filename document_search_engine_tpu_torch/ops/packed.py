"""The plain PyTorch packed scorers: the kernels' reference twins.

Port of `document_search_engine_tpu/ops/packed.py`. `search_packed_tables`
consumes the very same per-(query, block) plan tables as the fused CUDA
kernel (ops/fused.py) and is the kernel's plain version: the CPU path,
the ground truth the kernel is held against on the card, and the
engine's "xla" (alias "plain") scorer mode. The "xla_rank" mode runs
pack_tables here, then the rank-only kernel (ops/rank.py) in place of
stages 3-5. The reference's two other scorers pack without plan tables:
`search_packed` gathers each posting by index (from indptr-contiguous
rows, or from `row_start`-aligned ones), and `search_packed_ds` copies
whole `block`-record blocks of the aligned planes (`pack_ds`, then
`rank_candidates`); `pack_ds` followed by ops/rank.py
`rank_candidates_kernel` is the reference's `search_packed_ds(
use_rank_pallas=True)`, with the rank-only kernel on CUDA tensors.
Per query:

1. pack     — every plan block reads `block` records of the aligned
              planes at its source row (a block read past the row's end
              is masked by `rem`; skipped blocks by srcrow < 0);
2. quantize — ci = clip(rne((A_s * val) * 2^bits), 0, clip) in int32;
3. sort     — by doc id (co-permuting the contributions);
4. reduce   — a doc occupies <= s adjacent positions: s-1 shifted
              compare-add windows give each doc's integer run-sum;
5. rank     — top-k over run ends by (score desc, doc asc), on a unique
              int64 composite key, so torch.topk never meets a tie.

Every step is order-free integer math on identically rounded f32
products, so the result is the reference's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..index.csr import NNZ_SLICE_MARGIN

LANES = 128


def total_cap(indptr: np.ndarray, rows: np.ndarray, found: np.ndarray) -> int:
    """Packed budget C for a batch: max per-query total postings, pow-2
    bucketed."""
    if len(indptr) < 2 or rows.size == 0:  # empty segment or no queries
        return 16
    lens = (indptr[rows + 1] - indptr[rows]) * found
    m = int(lens.sum(axis=1).max())
    return max(16, 1 << int(np.ceil(np.log2(max(m, 1)))))


def quantize(a, v, scale: float, clip: float, valid):
    """Stage 2: int32 clip(rne((a * v) * scale), 0, clip), 0 where not
    valid; two f32 multiplies, each rounded, in this order."""
    # a fill on the device, not a copy from the host: the step runs
    # under CUDA-graph capture (engine/step_graph.py)
    scale_t = torch.full((), scale, dtype=torch.float32, device=v.device)
    ci = torch.round((a * v) * scale_t).clamp(0.0, clip).to(torch.int32)
    return torch.where(valid, ci, torch.zeros_like(ci))


def rank_candidates(
    d_key: torch.Tensor,  # (nq, C) int32 doc ids, n_docs = padding
    ci: torch.Tensor,  # (nq, C) int32 quantized contributions
    doc_base: int,
    s: int,
    k: int,
    n_docs: int,
):
    """Sort by doc, window run-sums, ranked top-k. Returns (vals, gids)
    (nq, k) int32, ranked (score desc, gid asc); (-1, -1) when exhausted."""
    nq, c_total = d_key.shape
    dev = d_key.device
    d_s, order = torch.sort(d_key, dim=1, stable=True)
    ci_s = torch.gather(ci, 1, order)

    next_d = torch.cat(
        [d_s[:, 1:], torch.full((nq, 1), -2, dtype=d_s.dtype, device=dev)],
        dim=1,
    )
    last = d_s != next_d
    run_sum = ci_s.clone()
    for j in range(1, min(s, c_total)):
        d_shift = torch.cat(
            [
                torch.full((nq, j), -1, dtype=d_s.dtype, device=dev),
                d_s[:, : c_total - j],
            ],
            dim=1,
        )
        ci_shift = torch.cat(
            [
                torch.zeros((nq, j), dtype=ci_s.dtype, device=dev),
                ci_s[:, : c_total - j],
            ],
            dim=1,
        )
        run_sum = run_sum + torch.where(
            d_shift == d_s, ci_shift, torch.zeros_like(ci_shift)
        )

    cand = torch.where(
        last & (d_s < n_docs) & (run_sum > 0),
        run_sum,
        torch.full_like(run_sum, -1),
    )
    kk = min(k, c_total)
    # (cand desc, position asc) as one unique int64 key; rows are
    # doc-ascending, so position order is doc order
    pos = torch.arange(c_total, dtype=torch.int64, device=dev)
    comp = cand.to(torch.int64) * (1 << 32) + (c_total - 1 - pos)
    _top, sel = torch.topk(comp, kk, dim=1)
    vals = torch.gather(cand, 1, sel)
    gids = torch.gather(d_s, 1, sel) + doc_base
    hit = vals > 0
    gids = torch.where(hit, gids, torch.full_like(gids, -1))
    vals = torch.where(hit, vals, torch.full_like(vals, -1))
    if kk < k:
        fill = torch.full((nq, k - kk), -1, dtype=vals.dtype, device=dev)
        vals = torch.cat([vals, fill], dim=1)
        gids = torch.cat([gids, fill], dim=1)
    return vals, gids


def pack_tables(
    post_doc2: torch.Tensor,  # (X, 128) i32 aligned doc plane
    post_val2: torch.Tensor,  # (X, 128) i32 aligned bitcast-f32 vals
    srcrow: torch.Tensor,  # (nq, 1, NB) i32 plan (ops/fused.py)
    rem: torch.Tensor,  # (nq, 1, NB) i32
    abits: torch.Tensor,  # (nq, 1, NB) i32 bitcast-f32 slot coefficients
    scale: float,  # f32(2^scale_bits) as a Python float
    clip: float,  # f32 per-contribution clip as a Python float
    n_blocks: int,
    block: int,
    n_docs: int,
    dlim: torch.Tensor | None = None,  # (nq, 1, 2) i32 [d_lo, d_hi)
):
    """Stages 1-2 (pack, quantize): (d_key, ci) (nq, n_blocks * block)
    int32, every aligned `block`-run doc-ascending with a sentinel tail
    (doc n_docs, ci 0) — the layout the rank-only kernel (ops/rank.py)
    merges. dlim masks postings outside [d_lo, d_hi) like rem-tail
    padding (the reference twin's form; the kernel's is in
    csrc/fused_search.cu)."""
    assert block <= NNZ_SLICE_MARGIN, (
        f"block={block} exceeds the builder's slice margin "
        f"({NNZ_SLICE_MARGIN}); tail blocks would read clamped sources"
    )
    nq = srcrow.shape[0]
    dev = post_doc2.device
    srcrow2 = srcrow.reshape(nq, n_blocks)
    rem2 = rem.reshape(nq, n_blocks)
    a_b = abits.reshape(nq, n_blocks).contiguous().view(torch.float32)
    doc_flat = post_doc2.reshape(-1)
    val_flat = post_val2.reshape(-1)
    # jax.lax.dynamic_slice semantics: the start clamps so that the
    # whole block lies inside the plane (the builders' tail margin makes
    # the clamp a no-op for every real plan)
    src = srcrow2.clamp(min=0).to(torch.int64) * LANES
    src = src.clamp(max=max(doc_flat.numel() - block, 0))
    lane = torch.arange(block, dtype=torch.int64, device=dev)
    idx = src[:, :, None] + lane
    d_b = doc_flat[idx]  # (nq, NB, block)
    v = val_flat[idx].view(torch.float32)
    valid = (lane.to(torch.int32) < rem2[:, :, None]) & (
        srcrow2[:, :, None] >= 0
    )
    if dlim is not None:
        dl = dlim.reshape(nq, 1, 2)
        valid = valid & (d_b >= dl[:, :, 0:1]) & (d_b < dl[:, :, 1:2])
    ci = quantize(a_b[:, :, None], v, scale, clip, valid).reshape(
        nq, n_blocks * block
    )
    d_key = torch.where(valid, d_b, torch.full_like(d_b, n_docs)).reshape(
        nq, n_blocks * block
    )
    return d_key, ci


def search_packed_tables(
    post_doc2: torch.Tensor,  # (X, 128) i32 aligned doc plane
    post_val2: torch.Tensor,  # (X, 128) i32 aligned bitcast-f32 vals
    srcrow: torch.Tensor,  # (nq, 1, NB) i32 plan (ops/fused.py)
    rem: torch.Tensor,  # (nq, 1, NB) i32
    abits: torch.Tensor,  # (nq, 1, NB) i32 bitcast-f32 slot coefficients
    scale: float,  # f32(2^scale_bits) as a Python float
    clip: float,  # f32 per-contribution clip as a Python float
    doc_base: int,
    n_blocks: int,
    block: int,
    s: int,  # query slot count (bounds per-doc occurrences per row)
    k: int,
    n_docs: int,
    dlim: torch.Tensor | None = None,  # (nq, 1, 2) i32 [d_lo, d_hi)
):
    """(vals, gids) (nq, k) int32 from the plan tables, ranked (score
    desc, gid asc); (-1, -1) for exhausted slots. Memory is
    O(nq * n_blocks * block): callers chunk large batches.

    dlim: per plan row, postings whose doc lies outside [d_lo, d_hi) are
    masked like rem-tail padding."""
    d_key, ci = pack_tables(
        post_doc2, post_val2, srcrow, rem, abits, scale, clip, n_blocks,
        block, n_docs, dlim=dlim,
    )
    return rank_candidates(d_key, ci, doc_base, s, k, n_docs)


def search_packed(
    indptr: torch.Tensor,  # (T+1,) int32
    post_doc: torch.Tensor,  # (nnz_pad,) int32
    post_val: torch.Tensor,  # (nnz_pad,) f32 — 0 for tombstoned docs
    rows: torch.Tensor,  # (nq, S) int32 (0 where missing)
    coeff: torch.Tensor,  # (nq, S) f32 (0 where missing)
    scale: float,  # f32(2^scale_bits) as a Python float
    clip: float,  # f32 per-contribution clip as a Python float
    doc_base: int,  # global id of local doc 0
    c_total: int,  # packed budget (total_cap)
    k: int,
    n_docs: int,  # local doc-id sentinel for padding (> any real doc)
    row_start: torch.Tensor | None = None,  # (T,) aligned starts (else
    #                                         rows are indptr-contiguous)
):
    """The gather-packed scorer: (vals, gids) (nq, k) int32, ranked
    (score desc, gid asc), matching (score > 0) docs only; exhausted
    slots are (-1, -1). Each query's slots are laid end to end in a
    (nq, c_total) buffer, every position gathered by index."""
    nq, s = rows.shape
    dev = post_doc.device
    ip = indptr.to(torch.int64)
    r = rows.to(torch.int64)
    starts = (ip if row_start is None else row_start.to(torch.int64))[r]
    lens = ip[r + 1] - ip[r]
    lens = torch.where(coeff > 0, lens, torch.zeros_like(lens))
    cum = torch.cat(
        [torch.zeros((nq, 1), dtype=torch.int64, device=dev),
         torch.cumsum(lens, dim=1)], dim=1,
    )  # (nq, S+1)
    p = torch.arange(c_total, dtype=torch.int64, device=dev)[None, :]
    valid = p < cum[:, -1:]  # (nq, C)
    # per-position slot attributes by masked sums over the S slots
    idx = torch.zeros((nq, c_total), dtype=torch.int64, device=dev)
    a = torch.zeros((nq, c_total), dtype=torch.float32, device=dev)
    for j in range(s):
        in_j = (p >= cum[:, j : j + 1]) & (p < cum[:, j + 1 : j + 2])
        idx = idx + torch.where(
            in_j, starts[:, j : j + 1] + (p - cum[:, j : j + 1]), 0
        )
        a = a + torch.where(in_j, coeff[:, j : j + 1], 0.0)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    d = post_doc[idx]
    ci = quantize(a, post_val[idx], scale, clip, valid)
    d_key = torch.where(valid, d, torch.full_like(d, n_docs))
    return rank_candidates(d_key, ci, doc_base, s, k, n_docs)


def _src_table(starts, lens, n_blocks: int, block: int, nnz_pad: int):
    """(nq, n_blocks) int64 flat source offsets (-1 = skip), and the
    per-slot cumulative block counts (nq, S+1): slot t owns the blocks
    [blk_cum[t], blk_cum[t + 1]) of its query."""
    nq, s = starts.shape
    dev = starts.device
    nblk = -(-lens // block)  # (nq, S), ceil
    blk_cum = torch.cat(
        [torch.zeros((nq, 1), dtype=nblk.dtype, device=dev),
         torch.cumsum(nblk, dim=1)], dim=1,
    )
    j = torch.arange(n_blocks, dtype=torch.int64, device=dev)[None, :]
    src = torch.full((nq, n_blocks), -1, dtype=torch.int64, device=dev)
    for t in range(s):
        in_t = (j >= blk_cum[:, t : t + 1]) & (j < blk_cum[:, t + 1 : t + 2])
        off = (j - blk_cum[:, t : t + 1]) * block
        src = torch.where(in_t, starts[:, t : t + 1] + off, src)
    # clamp so src + block stays in bounds (tail blocks read past the
    # row; those lanes are masked downstream)
    src = torch.where(src >= 0, src.clamp(max=nnz_pad - block), src)
    return src, blk_cum


def pack_ds(
    post_doc2: torch.Tensor,  # (X, 128) int32 aligned doc plane
    post_val2: torch.Tensor,  # (X, 128) int32 aligned bitcast-f32 vals;
    #                           0 for tombstoned docs
    indptr: torch.Tensor,  # (T+1,) int32 — true cumulative lengths
    row_start: torch.Tensor,  # (T,) int32 — aligned flat row starts
    rows: torch.Tensor,  # (nq, S) int32
    coeff: torch.Tensor,  # (nq, S) f32
    scale: float,  # f32(2^scale_bits) as a Python float
    clip: float,  # f32 per-contribution clip as a Python float
    n_blocks: int,  # per-query block budget (schedule.block_plan)
    n_docs: int,
    block: int = 512,
):
    """The slice-packed scorer's stages 1-2: (d_key, ci) (nq, n_blocks *
    block) int32. Each slot's row is copied in whole `block`-record
    blocks from its aligned start (one (nq, n_blocks, block) index
    gather of the flat planes); lanes past the row's end and unused
    blocks carry the sentinel doc n_docs with ci 0. Every aligned block
    is one CSR row's stretch, ascending with a sentinel tail: the
    block-run-sorted layout that ops/rank.py rank_kernel merges."""
    # Builders pad the planes by NNZ_SLICE_MARGIN; a bigger block would
    # make _src_table clamp tail-block sources, silently misaligning that
    # block while its lanes stay marked valid. Fail loudly instead.
    assert block <= NNZ_SLICE_MARGIN, (
        f"block={block} exceeds the builder's nnz slice margin "
        f"({NNZ_SLICE_MARGIN}); tail blocks would read clamped sources"
    )
    nq, s = rows.shape
    dev = post_doc2.device
    ip = indptr.to(torch.int64)
    r = rows.to(torch.int64)
    starts = row_start.to(torch.int64)[r]
    lens = ip[r + 1] - ip[r]
    lens = torch.where(coeff > 0, lens, torch.zeros_like(lens))
    doc_flat = post_doc2.reshape(-1)
    val_flat = post_val2.reshape(-1)
    src, blk_cum = _src_table(starts, lens, n_blocks, block,
                              doc_flat.numel())
    lane = torch.arange(block, dtype=torch.int64, device=dev)
    idx = src.clamp(min=0)[:, :, None] + lane  # (nq, NB, block)
    d = doc_flat[idx]
    v = val_flat[idx].view(torch.float32)
    # per-block slot attribution (block-aligned regions)
    blk = torch.arange(n_blocks, dtype=torch.int64, device=dev)[None, :]
    a_b = torch.zeros((nq, n_blocks), dtype=torch.float32, device=dev)
    rem_b = torch.zeros((nq, n_blocks), dtype=torch.int64, device=dev)
    for t in range(s):
        in_t = (blk >= blk_cum[:, t : t + 1]) & (
            blk < blk_cum[:, t + 1 : t + 2]
        )
        off_t = (blk - blk_cum[:, t : t + 1]) * block
        a_b = a_b + torch.where(in_t, coeff[:, t : t + 1], 0.0)
        rem_b = rem_b + torch.where(in_t, lens[:, t : t + 1] - off_t, 0)
    valid = lane < rem_b[:, :, None]
    ci = quantize(a_b[:, :, None], v, scale, clip, valid)
    d_key = torch.where(valid, d, torch.full_like(d, n_docs))
    return (d_key.reshape(nq, n_blocks * block),
            ci.reshape(nq, n_blocks * block))


def search_packed_ds(
    post_doc2: torch.Tensor,
    post_val2: torch.Tensor,
    indptr: torch.Tensor,
    row_start: torch.Tensor,
    rows: torch.Tensor,
    coeff: torch.Tensor,
    scale: float,
    clip: float,
    doc_base: int,
    n_blocks: int,
    k: int,
    n_docs: int,
    block: int = 512,
):
    """The slice-packed scorer, plain: pack_ds, then rank_candidates.
    (vals, gids) (nq, k) int32, the same as search_packed (tested).

    The reference's `use_rank_pallas=True` ranks the same buffers with
    its rank-only Pallas kernel; here that is pack_ds followed by
    ops/rank.py rank_candidates_kernel, which launches the rank-only
    CUDA kernel on CUDA tensors (entry.py's step)."""
    d_key, ci = pack_ds(
        post_doc2, post_val2, indptr, row_start, rows, coeff, scale, clip,
        n_blocks, n_docs, block=block,
    )
    return rank_candidates(d_key, ci, doc_base, rows.shape[1], k, n_docs)
