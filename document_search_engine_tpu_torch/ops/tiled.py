"""The heavy buckets' scorer: doc-range tiles in a shared-memory
accumulator (csrc/fused_tiled.cu), and its plain mirror.

`ops/fused.py fused_search` routes a bucket here by its shape
(`tiled_route`: regions of r_c >= TILED_MIN_RC rows, no doc limits, a
tile block that fits in shared memory); the light buckets, the split
path (dlim) and the dv plane keep the fused kernel. Both take the same plan tables and give the same (vals,
docs_local): a score is an integer sum, exact in any order, so the heavy
buckets sum each doc in an accumulator instead of sorting and merging
their pairs (the kernel's header says how).

The mirror follows the kernel's stages on the host: the runs of the plan
tables (`tiled_runs`, csrc/fused_tiled.cu scan_runs), each tile edge's
first posting in each run (binary search), each tile's sums, each
chunk's top k (`tiled_survivors`) and their merge. It is what
`tiled_search` runs on CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fused as F
from .fused import LANES, MAX_K, SLOT_SHIFT, _check_int32, _lib, check_launch

# csrc/fused_tiled.cu's compile-time constants: the tile W (docs an
# accumulator holds, 1 << kTileLog2) and the tiles a thread block walks
# (kTilesPerBlock), chosen on the card (PERF.md §6); the mirror takes
# others as arguments, which the CPU tests use at small tiles.
TILE_DOCS = 16384
TILES_PER_BLOCK = 32
TILED_THREADS = 512  # kTiledThreads, for the reports
# kTiledMaxSmem: the most dynamic shared memory a tile block takes
TILED_MAX_SMEM = 220 * 1024


def tiled_chunks(n_docs: int, tile: int = TILE_DOCS,
                 tiles_per_block: int = TILES_PER_BLOCK) -> int:
    """Thread blocks a query takes (csrc/fused_tiled.cu tiled_chunks):
    its ceil(n_docs / tile) tiles, tiles_per_block a block, at least
    one."""
    tiles = -(-n_docs // tile)
    return max(1, -(-tiles // tiles_per_block))


def tiled_smem_bytes(n_blocks: int, s: int) -> int:
    """A tile block's dynamic shared memory (csrc/fused_tiled.cu
    tiled_smem_bytes): 1,024 candidate composites, the accumulator and
    bitmap of TILE_DOCS docs, the run table of n_blocks entries and the
    bounds table."""
    bound_words = max((TILES_PER_BLOCK + 1) * (2 * s + 1),
                      2 * (2 * n_blocks + 1))
    return (1024 * 8 + TILE_DOCS * 4 + TILE_DOCS // 8
            + (3 * n_blocks + 1) * 4 + 4 * bound_words)


def tiled_route(*, mode: str, k: int, split: bool, r_c: int, n_blocks: int,
                s: int) -> bool:
    """Whether a bucket is scored by the tiled kernels, from what the
    step knows of it: the fused scorer's buckets (mode "fused" at k <=
    MAX_K, which `_batch_step` sends to fused_search) without doc limits
    (no split), of regions of r_c >= ops/fused.py TILED_MIN_RC rows, whose
    tile block fits in shared memory (its run table grows with n_blocks).
    fused_search routes by it, `_dispatch` counts `step.tiled_pairs` by
    it, and the reports of tools/roofline.py and chip_smoke.py name the
    kernel by it."""
    return (mode == "fused" and k <= MAX_K and not split
            and r_c >= F.TILED_MIN_RC
            and tiled_smem_bytes(n_blocks, s) <= TILED_MAX_SMEM)


def tiled_runs(srcrow, rem, abits, dstrow, *, block: int, r_c: int):
    """The kernel's run table (csrc/fused_tiled.cu scan_runs), per query:
    a dict of int64 numpy arrays over its runs, in plan order: row (the
    first plane row), off (runs + 1 entries: where each run begins in the
    query's pairs; the last is the total) and coeff (f32 bits). A block's
    valid pairs are min(max(rem, 0), block), 0 when skipped, cut where
    the region's r_c * 128 pairs end; a block continues the one before
    when that one is full, of the same slot and coefficient, and this one
    starts block / 128 rows after it."""
    c = r_c * LANES
    nq = srcrow.shape[0]
    sr, rm, ab, ds = (np.asarray(t).reshape(nq, -1).astype(np.int64)
                      for t in (srcrow, rem, abits, dstrow))
    slot = (ds & 0xFFFFFFFF) >> SLOT_SHIFT
    v = np.where(sr >= 0, np.clip(rm, 0, block), 0)
    incl = np.cumsum(v, axis=1)
    at = np.minimum(incl - v, c)
    valid = np.minimum(incl, c) - at
    full = np.zeros_like(valid, bool)
    full[:, 1:] = (
        (valid[:, :-1] == block) & (sr[:, :-1] >= 0)
        & (sr[:, 1:] == sr[:, :-1] + block // LANES)
        & (slot[:, 1:] == slot[:, :-1]) & (ab[:, 1:] == ab[:, :-1])
    )
    start = (valid > 0) & ~full
    out = []
    for q in range(nq):
        total = min(int(incl[q, -1]), c) if incl.shape[1] else 0
        out.append({
            "row": sr[q][start[q]],
            "off": np.append(at[q][start[q]], total),
            "coeff": ab[q][start[q]],
        })
    return out


def _ci(coeff_bits, val_bits, scale: float, clip: float) -> np.ndarray:
    """int64 clip(rne((a * val) * scale), 0, clip) of f32 bits, the two
    multiplies rounded in this order (ops/packed.py quantize)."""
    a = torch.from_numpy(np.asarray(coeff_bits, np.int32)).view(torch.float32)
    val = torch.from_numpy(np.asarray(val_bits, np.int32)).view(torch.float32)
    scale_t = torch.tensor(scale, dtype=torch.float32)
    ci = torch.round((a * val) * scale_t).clamp(0.0, clip)
    return ci.to(torch.int64).numpy()


def tiled_survivors(post_doc, post_val, srcrow, rem, abits, dstrow, *,
                    block: int, k: int, n_docs: int, scale: float,
                    clip: float, r_c: int, tile: int = TILE_DOCS,
                    tiles_per_block: int = TILES_PER_BLOCK) -> np.ndarray:
    """(nq, chunks, k) int64: each chunk's top k composites (sum << 32) |
    (0x7fffffff - doc) in descending order, 0 past the last: what the
    tile kernel leaves for the merge, up to the order within a chunk.
    Per tile [t * tile, (t + 1) * tile), its edges clipped to n_docs, the
    postings of each run between the edges' first postings add their ci
    into the tile's sums; a doc whose sum is positive is a candidate."""
    flat_d = np.asarray(post_doc).reshape(-1).astype(np.int64)
    flat_v = np.asarray(post_val).reshape(-1).view(np.int32)
    n_tiles = -(-n_docs // tile)
    chunks = tiled_chunks(n_docs, tile, tiles_per_block)
    nq = srcrow.shape[0]
    surv = np.zeros((nq, chunks, k), np.int64)
    edges = np.minimum(np.arange(n_tiles + 1, dtype=np.int64) * tile, n_docs)
    for q, runs in enumerate(tiled_runs(srcrow, rem, abits, dstrow,
                                        block=block, r_c=r_c)):
        spans = []
        for row, lo, hi, cb in zip(runs["row"], runs["off"][:-1],
                                   runs["off"][1:], runs["coeff"]):
            at = int(row) * LANES
            docs = flat_d[at: at + int(hi - lo)]
            spans.append((docs, flat_v[at: at + int(hi - lo)], int(cb),
                          np.searchsorted(docs, edges, side="left")))
        for chunk in range(chunks):
            comps = []
            for t in range(chunk * tiles_per_block,
                           min((chunk + 1) * tiles_per_block, n_tiles)):
                d_parts, ci_parts = [], []
                for docs, vals, cb, first in spans:
                    lo, hi = first[t], first[t + 1]
                    d_parts.append(docs[lo:hi])
                    ci_parts.append(_ci(np.full(hi - lo, cb), vals[lo:hi],
                                        scale, clip))
                if not d_parts:
                    continue
                d = np.concatenate(d_parts) - t * tile
                sums = np.bincount(d, weights=np.concatenate(ci_parts),
                                   minlength=tile).astype(np.int64)
                hit = np.nonzero(sums > 0)[0]
                comps.append((sums[hit] << 32)
                              | (0x7FFFFFFF - (hit + t * tile)))
            if comps:
                top = -np.sort(-np.concatenate(comps))[:k]
                surv[q, chunk, :len(top)] = top
    return surv


def merge_survivors(surv: np.ndarray, k: int):
    """The merge kernel's (vals, docs) (nq, k) int32 from (nq, chunks, k)
    survivors: the top k composites of each query, ranked; (-1, -1) past
    the last."""
    nq = surv.shape[0]
    comp = -np.sort(-surv.reshape(nq, -1), axis=1)[:, :k]
    if comp.shape[1] < k:
        comp = np.pad(comp, ((0, 0), (0, k - comp.shape[1])))
    live = comp > 0
    vals = np.where(live, comp >> 32, -1).astype(np.int32)
    docs = np.where(live, 0x7FFFFFFF - (comp & 0xFFFFFFFF), -1)
    return vals, docs.astype(np.int32)


def tiled_search_plain(post_doc, post_val, srcrow, rem, abits, dstrow, *,
                       block: int, k: int, n_docs: int, scale: float,
                       clip: float, r_c: int, tile: int = TILE_DOCS,
                       tiles_per_block: int = TILES_PER_BLOCK):
    """The plain mirror of the tiled kernels: (vals, docs_local) (nq, k)
    int32 tensors on post_doc's device."""
    surv = tiled_survivors(
        *(t.cpu().numpy() for t in (post_doc, post_val, srcrow, rem, abits,
                                    dstrow)),
        block=block, k=k, n_docs=n_docs, scale=scale, clip=clip, r_c=r_c,
        tile=tile, tiles_per_block=tiles_per_block,
    )
    vals, docs = merge_survivors(surv, k)
    dev = post_doc.device
    return torch.from_numpy(vals).to(dev), torch.from_numpy(docs).to(dev)


def launch_tiled(post_doc, post_val, srcrow, rem, abits, dstrow, *,
                 n_blocks: int, block: int, s: int, k: int, n_docs: int,
                 scale: float, clip: float, r_c: int):
    """Checks the arguments and launches the tile kernel and the merge on
    CUDA tensors, on the current stream, with the survivors' scratch
    (nq x chunks x k int64) from torch.empty. Returns (vals, docs)."""
    dev = post_doc.device
    nq = srcrow.shape[0]
    for name, t in (("post_doc", post_doc), ("post_val", post_val)):
        _check_int32(name, t, dev)
        if t.ndim != 2 or t.shape[1] != LANES or t.data_ptr() % 16:
            raise ValueError(f"{name}: a 16-byte aligned (X, {LANES}) plane")
    if post_val.shape != post_doc.shape:
        raise ValueError("post_val: shape differs from post_doc")
    for name, t in (("srcrow", srcrow), ("rem", rem), ("abits", abits),
                    ("dstrow", dstrow)):
        _check_int32(name, t, dev, (nq, 1, n_blocks))
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(f"k={k}: the tiled kernel serves k <= "
                                  f"{MAX_K}")
    if tiled_smem_bytes(n_blocks, s) > TILED_MAX_SMEM:
        raise ValueError(f"n_blocks={n_blocks}, s={s}: more shared memory "
                         "than a tile block has")
    vals = torch.empty((nq, k), dtype=torch.int32, device=dev)
    docs = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return vals, docs
    surv = torch.empty(nq * tiled_chunks(n_docs) * k, dtype=torch.int64,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().dse_tiled_search(
            post_doc.data_ptr(), post_val.data_ptr(),
            *(t.data_ptr() for t in (srcrow, rem, abits, dstrow)),
            nq, n_blocks, block, s, k, n_docs, scale, clip, r_c,
            surv.data_ptr(), vals.data_ptr(), docs.data_ptr(), stream,
        )
    check_launch("tiled_search", err)
    return vals, docs


def tiled_search(post_doc, post_val, srcrow, rem, abits, dstrow, *,
                 n_blocks: int, block: int, s: int, k: int, n_docs: int,
                 scale: float, clip: float, r_c: int):
    """(vals, docs_local) (nq, k) int32 of a heavy bucket: the kernels on
    CUDA tensors, the plain mirror on CPU tensors."""
    dev = post_doc.device
    if dev.type == "cpu":
        return tiled_search_plain(
            post_doc, post_val, srcrow, rem, abits, dstrow, block=block,
            k=k, n_docs=n_docs, scale=scale, clip=clip, r_c=r_c,
        )
    if dev.type != "cuda":
        raise ValueError(f"tiled_search: unsupported device {dev}")
    return launch_tiled(
        post_doc, post_val, srcrow, rem, abits, dstrow, n_blocks=n_blocks,
        block=block, s=s, k=k, n_docs=n_docs, scale=scale, clip=clip,
        r_c=r_c,
    )


def tiled_blocks_per_sm(n_blocks: int, s: int) -> int:
    """Resident tile blocks an SM at a bucket's shape (the card only)."""
    return _lib().dse_tiled_blocks_per_sm(n_blocks, s)
