"""Hybrid retrieval: dense feature-hash rerank of lexical candidates.

Port of `document_search_engine_tpu/ops/rerank.py`. Embeddings are
deterministic feature-hash projections of each doc's impact profile:
posting (term t, doc d, val v) adds `rne(v * 2^EMB_QBITS) * sign(t)` to
column `col(t) = (hash(t) >> 8) % dim`, with `sign(t) = +-1` from hash
bit 40. Cells are integer sums (order-free), clipped to int8.

Every device-side number is an exact integer: embedding cells (int8),
squared norms (int32) and candidate dots (int32; |cell| <= EMB_CLIP keeps
each dot under 2^20). Only the cosine and its quantization run on the
host, in float64 from those integers, so rankings are the same on every
backend.

- `term_projection`, `doc_embeddings_int` (the host reference),
  `query_embeddings_int` and `rerank_order_int` are host numpy copies of
  the reference's.
- `device_doc_embeddings_int` builds the table on the device from the
  resident (X, 128) posting planes with an int32 scatter-add.
- `gather_and_dot` launches the CUDA kernel csrc/rerank_dots.cu (which
  replaces the reference's Pallas `rerank_dots_pallas`) for CUDA tensors
  and takes its plain version `gather_and_dot_plain` for CPU tensors.
  `dots_vec` and `dots_launch` choose the kernel's launch shape;
  `dots_reads` and `gather_and_dot_mirror` mirror its layout for the CPU
  tests.
"""
from __future__ import annotations

import numpy as np
import torch

F32 = np.float32

EMB_QBITS = 5  # contribution quantization: rne(val * 2^5)
EMB_CLIP = 63  # |cell| bound; dots <= dim * 63^2 stay exact
# plane rows per scatter chunk of the device build: 8M records, ~0.2 GB
# of index temporaries
CHUNK_ROWS = 1 << 16


def term_projection(term_hash: np.ndarray, dim: int):
    """(col int32, sign int32 +-1) per vocab term from its 64-bit hash."""
    col = ((term_hash >> np.uint64(8)) % np.uint64(dim)).astype(np.int32)
    sign = np.where(
        (term_hash >> np.uint64(40)) & np.uint64(1), -1, 1
    ).astype(np.int32)
    return col, sign


def doc_embeddings_int(
    term_hash: np.ndarray,
    indptr: np.ndarray,
    post_doc: np.ndarray,  # (nnz,) contiguous
    post_val: np.ndarray,  # (nnz,) f32 contiguous
    n_docs: int,
    dim: int,
):
    """Host reference builder: (emb int8 (n_docs, dim), ssq int32
    (n_docs,)). Bit-identical to device_doc_embeddings_int (tested)."""
    col, sign = term_projection(term_hash, dim)
    nnz = int(indptr[-1])
    row_of = np.repeat(
        np.arange(len(term_hash), dtype=np.int64),
        np.diff(indptr).astype(np.int64),
    )
    ci = np.rint(
        post_val[:nnz].astype(F32) * F32(2.0**EMB_QBITS)
    ).astype(np.int64) * sign[row_of]
    emb = np.zeros((n_docs, dim), dtype=np.int64)
    np.add.at(emb, (post_doc[:nnz].astype(np.int64), col[row_of]), ci)
    emb = np.clip(emb, -EMB_CLIP, EMB_CLIP).astype(np.int8)
    ssq = (emb.astype(np.int32) ** 2).sum(axis=1).astype(np.int32)
    return emb, ssq


def device_doc_embeddings_int(
    post_doc2: torch.Tensor,  # (X, 128) i32 aligned doc plane
    post_val2: torch.Tensor,  # (X, 128) i32 aligned bitcast-f32 vals
    row_start: torch.Tensor,  # (T,) i32 aligned row starts
    term_col: torch.Tensor,  # (T,) i32 projection columns
    term_sign: torch.Tensor,  # (T,) i32 +-1
    n_docs: int,
    dim: int,
):
    """Device builder over the resident posting planes (the postings
    never leave the device): (emb int8 (n_docs, dim), ssq int32
    (n_docs,)). The scatter-add is an int32 `index_put_(accumulate=True)`
    into an (n_docs + 1, dim) scratch table (4 B a cell, freed on
    return), fed CHUNK_ROWS plane rows at a time so its index
    temporaries stay small; integer sums are order-free, so atomics give
    the exact result, bit-identical to the host reference."""
    x_rows = post_doc2.shape[0]
    dev = post_doc2.device
    emb = torch.zeros((n_docs + 1) * dim, dtype=torch.int32, device=dev)
    for lo in range(0, x_rows, CHUNK_ROWS):
        hi = min(lo + CHUNK_ROWS, x_rows)
        # each 128-record plane row belongs to exactly one term (rows are
        # 128-aligned); among equal starts the last duplicate is the only
        # one with nonzero length, which searchsorted(right=True) picks
        plane_start = torch.arange(lo, hi, dtype=torch.int32,
                                   device=dev) * 128
        term_of = torch.searchsorted(row_start, plane_start, right=True) - 1
        term_of = term_of.clamp(0, row_start.shape[0] - 1)
        col = term_col[term_of][:, None]  # (rows, 1)
        sign = term_sign[term_of][:, None]
        val = post_val2[lo:hi].view(torch.float32)
        # torch.round is half to even, like jnp.round / np.rint
        ci = torch.round(val * float(2.0**EMB_QBITS)).to(torch.int32) * sign
        # sentinel docs land in the scratch row n_docs
        doc = post_doc2[lo:hi].clamp(max=n_docs).to(torch.int64)
        flat = doc * dim + col.to(torch.int64)
        emb.index_put_((flat.reshape(-1),), ci.reshape(-1), accumulate=True)
    # in place on the scratch table, so the build's peak stays one table
    tab = emb.view(n_docs + 1, dim)[:n_docs].clamp_(-EMB_CLIP, EMB_CLIP)
    out = tab.to(torch.int8)
    ssq = tab.square_().sum(dim=1, dtype=torch.int32)
    return out, ssq


def query_embeddings_int(slot_h: np.ndarray, coeff: np.ndarray, dim: int):
    """(emb int8 (nq, dim), ssq int64 (nq,)) query projections — host
    math, scaled so the largest |cell| uses the full clip range."""
    nq = slot_h.shape[0]
    emb = np.zeros((nq, dim), dtype=np.float64)
    col, sign = term_projection(slot_h.reshape(-1), dim)
    col = col.reshape(slot_h.shape)
    sign = sign.reshape(slot_h.shape)
    for s in range(slot_h.shape[1]):
        np.add.at(
            emb,
            (np.arange(nq), col[:, s]),
            coeff[:, s].astype(np.float64) * sign[:, s],
        )
    peak = np.abs(emb).max(axis=1)
    peak = np.where(peak == 0, 1.0, peak)
    q = np.rint(emb / peak[:, None] * EMB_CLIP).astype(np.int8)
    ssq = (q.astype(np.int64) ** 2).sum(axis=1)
    return q, ssq


def gather_and_dot_plain(emb, ssq, qemb, gids):
    """The plain PyTorch version of gather_and_dot: the (nq, K, dim)
    candidate rows are gathered into memory, then dotted in int32."""
    safe = gids.clamp(min=0).to(torch.int64)
    cand = emb[safe].to(torch.int32)  # (nq, K, dim)
    dots = (cand * qemb.to(torch.int32)[:, None, :]).sum(
        dim=2, dtype=torch.int32
    )
    return dots, ssq[safe]


# csrc/rerank_dots.cu kDotsThreads and kDotsSlots: threads a block, and
# candidates each lane group holds in flight
DOTS_THREADS = 256
DOTS_SLOTS = 4


def dots_vec(dim: int, *ptrs: int) -> int:
    """Bytes a load of csrc/rerank_dots.cu: 16 where dim % 16 == 0 and
    every base address in `ptrs` (emb's and qemb's) is 16-byte aligned,
    else 4."""
    return 16 if dim % 16 == 0 and all(p % 16 == 0 for p in ptrs) else 4


def dots_launch(nq: int, kc: int, dim: int, vec: int) -> dict:
    """The dots kernel's launch shape for (nq, K) candidates of dim-byte
    rows read `vec` bytes a load: `lanes` threads a row (a power of two,
    min(32, >= dim / vec)) reading chunks lane + lanes * i for i <
    `rounds`; `groups` rows a block step; `qb` queries a block (the most,
    a power of two, whose `tile` = groups / qb * DOTS_SLOTS candidates
    still hold K); grid (queries, candidate tiles)."""
    chunks = dim // vec
    lanes = min(32, 1 << max(chunks - 1, 0).bit_length())
    groups = DOTS_THREADS // lanes
    qb = 1
    while 2 * qb <= groups and groups // (2 * qb) * DOTS_SLOTS >= kc:
        qb *= 2
    tile = groups // qb * DOTS_SLOTS
    return dict(vec=vec, chunks=chunks, lanes=lanes,
                rounds=-(-chunks // lanes), groups=groups, qb=qb,
                per_q=groups // qb, tile=tile,
                grid=(-(-nq // qb), -(-kc // tile)))


def _cells(lay, nq, kc):
    """Cell t of block (x, y) in the gid and write phases: query x * qb +
    t // tile, candidate y * tile + t % tile; (q, j, in range) over
    (grid x, grid y, qb * tile)."""
    gx, gy = lay["grid"]
    t = np.arange(lay["qb"] * lay["tile"])
    q = np.arange(gx)[:, None, None] * lay["qb"] + t // lay["tile"]
    j = np.arange(gy)[None, :, None] * lay["tile"] + t % lay["tile"]
    q, j = np.broadcast_arrays(q, j)
    return q, j, (q < nq) & (j < kc)


def dots_reads(nq: int, kc: int, dim: int, vec: int) -> dict:
    """Every row read of the dots kernel, as int64 arrays over (grid x,
    grid y, thread, slot, round): the thread's lane, the cell its
    group's slot stages (qi * tile + group % per_q + per_q * slot),
    query q, candidate j, chunk c; `slot_live` (q < nq and j < K: the
    slot holds a candidate) and `live` (slot_live and c < chunks: the
    read is issued)."""
    lay = dots_launch(nq, kc, dim, vec)
    gx, gy = lay["grid"]
    lanes, per_q = lay["lanes"], lay["per_q"]
    bx, by, th, s, i = np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(DOTS_THREADS),
        np.arange(DOTS_SLOTS), np.arange(lay["rounds"]), indexing="ij")
    grp = th // lanes
    qi, jg = grp // per_q, grp % per_q
    q = bx * lay["qb"] + qi
    j = by * lay["tile"] + jg + per_q * s
    c = th % lanes + lanes * i
    slot_live = (q < nq) & (j < kc)
    return dict(lane=th % lanes, cell=qi * lay["tile"] + jg + per_q * s,
                q=q, j=j, c=c, slot_live=slot_live,
                live=slot_live & (c < lay["chunks"]))


def gather_and_dot_mirror(emb, ssq, qemb, gids, vec: int):
    """gather_and_dot through the dots kernel's layout (numpy int8/int32
    arrays in, (dots, cand_ssq) int32 out): the gid phase into each
    block's cells, every lane's chunk products (dots_reads), the xor
    butterfly within each lane group, lane 0's staging, and the
    coalesced write of each block's cells. Raises where a cell is
    staged or a result written other than once."""
    n_docs, dim = emb.shape
    nq, kc = gids.shape
    lay = dots_launch(nq, kc, dim, vec)
    gx, gy = lay["grid"]
    lanes, slots = lay["lanes"], DOTS_SLOTS
    # 1. gids into each block's cells
    cq, cj, cok = _cells(lay, nq, kc)
    s_gid = np.full(cq.shape, -1, np.int64)
    s_gid[cok] = np.maximum(gids[cq[cok], cj[cok]], 0)
    # 2. every lane's products over its chunks, summed over its rounds
    r = dots_reads(nq, kc, dim, vec)
    bx = np.arange(gx)[:, None, None, None, None]
    by = np.arange(gy)[None, :, None, None, None]
    g = np.where(r["live"], s_gid[bx, by, r["cell"]], 0)
    if (g[r["live"]] < 0).any():
        raise AssertionError("a live read's cell holds no gid")
    rows = emb.reshape(n_docs, -1, vec).astype(np.int32)
    qrows = qemb.reshape(nq, -1, vec).astype(np.int32)
    cc = np.minimum(r["c"], lay["chunks"] - 1)
    prod = (rows[g, cc] * qrows[np.minimum(r["q"], nq - 1), cc]).sum(-1)
    acc = np.where(r["live"], prod, 0).sum(-1)  # (gx, gy, threads, slots)
    # 3. the xor butterfly within each group of `lanes` threads
    acc = acc.reshape(gx, gy, lay["groups"], lanes, slots)
    off = lanes // 2
    while off:
        acc = acc + acc[:, :, :, np.arange(lanes) ^ off, :]
        off //= 2
    acc = acc.reshape(gx, gy, DOTS_THREADS, slots)
    # 4. lane 0 stages its live slots; each cell in range is written
    x, y, t, sl = np.nonzero(r["slot_live"][..., 0]
                             & (r["lane"][..., 0] == 0))
    at = r["cell"][x, y, t, sl, 0]
    staged = np.zeros(cq.shape, np.int64)
    np.add.at(staged, (x, y, at), 1)
    if (staged != cok).any():
        raise AssertionError("a cell is staged twice, never, or off range")
    s_dot = np.zeros(cq.shape, np.int64)
    s_dot[x, y, at] = acc[x, y, t, sl]
    s_ssq = np.zeros(cq.shape, np.int64)
    s_ssq[x, y, at] = ssq[s_gid[x, y, at]]
    written = np.zeros((nq, kc), np.int64)
    np.add.at(written, (cq[cok], cj[cok]), 1)
    if (written != 1).any():
        raise AssertionError("a result is written twice or never")
    dots = np.zeros((nq, kc), np.int32)
    cand_ssq = np.zeros((nq, kc), np.int32)
    dots[cq[cok], cj[cok]] = s_dot[cok]
    cand_ssq[cq[cok], cj[cok]] = s_ssq[cok]
    return dots, cand_ssq


def gather_and_dot(
    emb: torch.Tensor,  # (n_docs, dim) int8
    ssq: torch.Tensor,  # (n_docs,) int32
    qemb: torch.Tensor,  # (nq, dim) int8
    gids: torch.Tensor,  # (nq, K) int32 candidate doc ids (-1 = dead)
):
    """(dots (nq, K) int32, cand_ssq (nq, K) int32): exact integer dots
    of each query's embedding with its candidates' rows, and the
    candidates' squared norms. Dead gids read row 0 (the host ordering
    masks them through lex <= 0).

    CUDA tensors launch csrc/rerank_dots.cu on the current stream, in
    the shape dots_launch gives (16-byte loads where dots_vec allows
    them, else 4-byte), and count one launch in gather_and_dot.launches;
    CPU tensors take gather_and_dot_plain."""
    dev = emb.device
    if dev.type == "cpu":
        return gather_and_dot_plain(emb, ssq, qemb, gids)
    if dev.type != "cuda":
        raise ValueError(f"gather_and_dot: unsupported device {dev}")
    from .fused import _lib

    for name, t, dtype in (
        ("emb", emb, torch.int8), ("ssq", ssq, torch.int32),
        ("qemb", qemb, torch.int8), ("gids", gids, torch.int32),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    n_docs, dim = emb.shape
    nq, kc = gids.shape
    if tuple(ssq.shape) != (n_docs,) or tuple(qemb.shape) != (nq, dim):
        raise ValueError(
            f"shapes: emb {tuple(emb.shape)}, ssq {tuple(ssq.shape)}, "
            f"qemb {tuple(qemb.shape)}, gids {tuple(gids.shape)}"
        )
    if dim % 4 or emb.data_ptr() % 4 or qemb.data_ptr() % 4:
        raise ValueError(f"dim={dim}: the kernel reads 4-byte words")
    dots = torch.empty((nq, kc), dtype=torch.int32, device=dev)
    cand_ssq = torch.empty((nq, kc), dtype=torch.int32, device=dev)
    if nq == 0 or kc == 0:
        return dots, cand_ssq
    if n_docs == 0:
        raise ValueError("gather_and_dot: empty embedding table")
    lay = dots_launch(nq, kc, dim,
                      dots_vec(dim, emb.data_ptr(), qemb.data_ptr()))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dse_rerank_dots(
            emb.data_ptr(), ssq.data_ptr(), qemb.data_ptr(), gids.data_ptr(),
            nq, kc, dim, lay["vec"], lay["lanes"], lay["qb"],
            dots.data_ptr(), cand_ssq.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"rerank_dots launch failed: CUDA error {err} "
            f"({lib.dse_error_string(err).decode()})"
        )
    gather_and_dot.launches += 1
    return dots, cand_ssq


gather_and_dot.launches = 0


def rerank_order_int(
    dots: np.ndarray,  # (nq, K) int32 exact dots
    ssq_q: np.ndarray,  # (nq,) int64
    ssq_d: np.ndarray,  # (nq, K) int32
    lex_vals: np.ndarray,  # (nq, K) int lexical scores (-1 = dead)
    gids: np.ndarray,  # (nq, K) int
    k: int,
    scale_bits: int = 20,
):
    """Final ranked (ids, rerank_int, lex) by (rerank desc, lex desc,
    gid asc); dead candidates sink. cosine = dot / sqrt(ssq_q * ssq_d)
    in host float64 from the exact device integers, then quantized."""
    denom = np.sqrt(
        ssq_q[:, None].astype(np.float64) * ssq_d.astype(np.float64)
    )
    denom = np.where(denom == 0, 1.0, denom)
    cos = dots.astype(np.float64) / denom
    ri = np.rint(cos * float(2.0**scale_bits)).astype(np.int64)
    ri = np.where(lex_vals > 0, ri, np.int64(-(2**40)))
    order = np.lexsort(
        (gids, -np.asarray(lex_vals, np.int64), -ri), axis=-1
    )[:, :k]
    out_ids = np.take_along_axis(gids, order, axis=1)
    out_ri = np.take_along_axis(ri, order, axis=1)
    out_lex = np.take_along_axis(
        np.asarray(lex_vals, np.int64), order, axis=1
    )
    dead = out_lex <= 0
    out_ids = np.where(dead, -1, out_ids)
    out_ri = np.where(dead, -1, out_ri)
    out_lex = np.where(dead, -1, out_lex)
    return out_ids, out_ri, out_lex
