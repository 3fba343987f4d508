"""The plain PyTorch scorer: the fused kernel's reference twin.

Port of `document_search_engine_tpu/ops/packed.py` (`search_packed_tables`
and `rank_candidates`). It consumes the very same per-(query, block) plan
tables as the fused CUDA kernel (ops/fused.py) and is the kernel's plain
version: the CPU path, the ground truth the kernel is held against on the
card, and the engine's "xla" (alias "plain") scorer mode. The "xla_rank"
mode runs pack_tables here, then the rank-only kernel (ops/rank.py) in
place of stages 3-5. Per query:

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

import torch

from ..index.csr import NNZ_SLICE_MARGIN

LANES = 128


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
    scale_t = torch.tensor(scale, dtype=torch.float32, device=dev)
    ci_f = torch.round((a_b[:, :, None] * v) * scale_t)
    ci = ci_f.clamp(0.0, clip).to(torch.int32)
    ci = torch.where(valid, ci, torch.zeros_like(ci)).reshape(
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
