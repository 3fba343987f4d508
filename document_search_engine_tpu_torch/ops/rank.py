"""The rank-only kernel: merge, run-sums and top-k over a packed buffer.

Port of the wrappers of `document_search_engine_tpu/ops/rank_pallas.py`
(`rank_pallas` and `rank_candidates_pallas`, lines 417-507), whose
Pallas kernel `_rank_kernel` (:405) is replaced by the CUDA kernel
csrc/rank_only.cu (the rank stage of csrc/rank.cuh behind its own
loader). It backs the engine's "xla_rank" scorer: the plain PyTorch pack
(ops/packed.py pack_tables), then this kernel in place of the sort-based
`packed.rank_candidates`, which is its plain version.

CUDA tensors launch the kernel; CPU tensors take `packed.rank_candidates`.
"""
from __future__ import annotations

import torch

from .packed import LANES, rank_candidates


def rank_kernel(
    d3: torch.Tensor,  # (nq, R, 128) i32 doc keys (sentinel n_docs pads)
    ci3: torch.Tensor,  # (nq, R, 128) i32 quantized contributions
    block: int,  # every aligned `block`-run of the flat row is ascending
    s: int,  # max occurrences of one doc per row (= active query slots)
    k: int,
    n_docs: int,
):
    """(vals, docs_local) (nq, k) int32, ranked (score desc, doc asc);
    exhausted slots are (-1, -1). The flat row-major view of (R, 128) is
    the candidate row.

    Precondition (as for rank_candidates): a doc id appears at most `s`
    times per row, which CSR rows of unique docs and one row per query
    slot guarantee. CUDA tensors count one launch in rank_kernel.launches."""
    nq, r_dim, lanes = d3.shape
    assert lanes == LANES
    c_total = r_dim * LANES
    assert c_total % block == 0 and (c_total & (c_total - 1)) == 0
    assert (block & (block - 1)) == 0 and block >= LANES
    assert 1 <= k <= LANES, "the kernel ranks at most 128"
    # the run-sum walks back at most s - 1 positions
    assert s <= LANES, f"s={s} exceeds the kernel's run-sum window"
    dev = d3.device
    if dev.type == "cpu":
        return rank_candidates(
            d3.reshape(nq, c_total), ci3.reshape(nq, c_total), 0, s, k,
            n_docs,
        )
    if dev.type != "cuda":
        raise ValueError(f"rank_kernel: unsupported device {dev}")
    from .fused import _check_int32, _lib, check_launch

    _check_int32("d3", d3, dev)
    _check_int32("ci3", ci3, dev, d3.shape)
    if d3.data_ptr() % 16 or ci3.data_ptr() % 16:
        raise ValueError("d3, ci3: must be 16-byte aligned")
    vals = torch.empty((nq, k), dtype=torch.int32, device=dev)
    docs = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return vals, docs
    lib = _lib()
    # two merge buffers a query, sized for the worst case (no padding);
    # the kernel takes a query's slice only when its real pairs do not
    # fit shared memory
    workspace = None
    if c_total * 8 > lib.dse_smem_region_bytes():
        workspace = torch.empty(nq * 2 * c_total, dtype=torch.int64,
                                device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dse_rank(
            d3.data_ptr(), ci3.data_ptr(), nq, c_total, block, s, k, n_docs,
            None if workspace is None else workspace.data_ptr(),
            vals.data_ptr(), docs.data_ptr(), stream,
        )
    check_launch("rank_kernel", err)
    rank_kernel.launches += 1
    return vals, docs


rank_kernel.launches = 0


def rank_candidates_kernel(
    d_key: torch.Tensor,  # (nq, C) i32
    ci: torch.Tensor,  # (nq, C) i32
    doc_base: int,
    block: int,
    s: int,
    k: int,
    n_docs: int,
):
    """Drop-in for packed.rank_candidates when the rows are `block`-run
    sorted (the pack_tables layout): (vals, gids) (nq, k) int32, the same
    outputs bit for bit."""
    nq, c_total = d_key.shape
    kk = min(k, c_total)
    vals, docs = rank_kernel(
        d_key.reshape(nq, c_total // LANES, LANES),
        ci.reshape(nq, c_total // LANES, LANES),
        block=block, s=s, k=kk, n_docs=n_docs,
    )
    gids = torch.where(vals > 0, docs + doc_base, torch.full_like(docs, -1))
    if kk < k:
        fill = torch.full((nq, k - kk), -1, dtype=vals.dtype,
                          device=vals.device)
        vals = torch.cat([vals, fill], dim=1)
        gids = torch.cat([gids, fill], dim=1)
    return vals, gids


# ------------------------------------------------------------------
# The merge of csrc/rank.cuh, as plain functions that mirror the device
# code line for line (natural_runs, corank, merge_runs). The kernels
# cannot run without a card; their index arithmetic can, here. Used by
# the tests and by chip_smoke.py's run statistics, never by the engine.
# Words are non-negative int64 (key << 32 | ci), so signed order is the
# kernel's unsigned order.
THREADS = 512  # csrc/rank.cuh kThreads


def real_lengths(words: torch.Tensor, granule: int, sentinel: int):
    """(..., C // granule) int64: per aligned granule of the (..., C)
    rows, the number of words below `sentinel`. A granule is ascending
    and the sentinel is its largest word, so they are a prefix: one
    binary search per granule, as the rank-only kernel's load stage."""
    g = words.reshape(*words.shape[:-1], -1, granule).contiguous()
    key = torch.full((*g.shape[:-1], 1), sentinel, dtype=words.dtype,
                     device=words.device)
    return torch.searchsorted(g, key).squeeze(-1)


def natural_run_starts(words: torch.Tensor, granule: int,
                       sentinel: int | None = None):
    """(..., C // granule) bool: the granules of the (..., C) rows at
    which a natural run starts once the sentinel tails are dropped: the
    non-empty granules whose first word is below the last real word in
    front of them (rank.cuh natural_runs: a[off - 1] > a[off]), and each
    row's first non-empty granule. Every granule is ascending; without a
    sentinel every word is real."""
    units = words.shape[-1] // granule
    g = words.reshape(*words.shape[:-1], units, granule)
    if sentinel is None:
        lens = torch.full(g.shape[:-1], granule, dtype=torch.int64,
                          device=words.device)
    else:
        lens = real_lengths(words, granule, sentinel)
    nonempty = lens > 0
    first = g[..., 0]
    last = torch.gather(g, -1, (lens - 1).clamp(min=0).unsqueeze(-1))
    last = last.squeeze(-1)
    # the last non-empty granule strictly before u, -1 if none
    idx = torch.arange(units, device=words.device).expand(lens.shape)
    seen = torch.where(nonempty, idx, torch.full_like(idx, -1))
    seen = torch.cummax(seen, dim=-1).values
    prev = torch.cat([torch.full_like(seen[..., :1], -1), seen[..., :-1]], -1)
    prev_last = torch.gather(last, -1, prev.clamp(min=0))
    return nonempty & ((prev < 0) | (prev_last > first))


def corank(x, y, diag: int) -> int:
    """Merge path (rank.cuh corank): how many of the first `diag`
    outputs of merge(x, y) come from x, ties taken from x first."""
    lx, ly = len(x), len(y)
    lo, hi = max(0, diag - ly), min(diag, lx)
    while lo < hi:
        mid = (lo + hi) >> 1
        if x[mid] <= y[diag - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def merge_path_sort(words: torch.Tensor, granule: int,
                    stretch: int | None = None, sentinel: int | None = None,
                    threads: int = THREADS):
    """Sorts one (C,) row the way the rank-only kernel does: the real
    prefix of every granule stored back to back, then merge_region.
    Returns (sorted real words (n,) int64, the number of natural runs, the
    number of levels)."""
    w = words.tolist()
    c = len(w)
    assert c % granule == 0
    if sentinel is None:
        lens = [granule] * (c // granule)
    else:
        lens = real_lengths(words, granule, sentinel).tolist()
    a, unit_off = [], []
    for u, ln in enumerate(lens):
        unit_off.append(len(a))
        a.extend(w[u * granule : u * granule + ln])
    unit_off.append(len(a))
    return merge_region(a, unit_off, stretch, threads)


def merge_region(a, unit_off, stretch: int | None = None,
                 threads: int = THREADS):
    """The rank stage over a region a[0, n) stored back to back in units
    a[unit_off[u], unit_off[u + 1]), each ascending, unit_off[-1] == n:
    the table of natural runs, then pairwise merge-path levels in which
    thread t writes outputs [t * stretch, (t + 1) * stretch) (default: the
    kernel's odd ceil(n / threads) | 1). Returns (sorted words (n,)
    int64, the number of natural runs, the number of levels)."""
    a = list(a)
    n = len(a)
    assert unit_off[-1] == n
    # natural_runs: non-empty units where order breaks
    off = [o for u, o in enumerate(unit_off[:-1])
           if unit_off[u + 1] > o and (o == 0 or a[o - 1] > a[o])]
    n_runs = len(off)
    off.append(n)
    if stretch is None:
        stretch = -(-n // threads) | 1
    src, dst, levels = a, [None] * n, 0
    wd = 1
    while wd < n_runs:
        for t in range(threads):
            p = min(n, t * stretch)
            p_end = min(n, p + stretch)
            while p < p_end:
                lo, hi = 0, (n_runs - 1) // (2 * wd)
                while lo < hi:
                    mid = (lo + hi + 1) >> 1
                    if off[mid * 2 * wd] <= p:
                        lo = mid
                    else:
                        hi = mid - 1
                g = lo * 2 * wd
                gs = off[g]
                gm = off[min(g + wd, n_runs)]
                ge = off[min(g + 2 * wd, n_runs)]
                x, y = src[gs:gm], src[gm:ge]
                stop = min(p_end, ge)
                i = corank(x, y, p - gs)
                j = p - gs - i
                while p < stop:
                    if j >= len(y) or (i < len(x) and x[i] <= y[j]):
                        dst[p] = x[i]
                        i += 1
                    else:
                        dst[p] = y[j]
                        j += 1
                    p += 1
        assert threads * stretch >= n
        src, dst = dst, [None] * n
        wd <<= 1
        levels += 1
    return torch.tensor(src, dtype=torch.int64), n_runs, levels


def rank_merged(words: torch.Tensor, s: int, k: int, n_docs: int, kb: int):
    """Run-sums and top-k of sorted (n,) int64 words (key << 32) | ci, as
    rank.cuh does (run_end_composite, then the top-k of either branch):
    each run end of a doc below n_docs sums the ci of at most s positions
    of its doc back, and the k best by (run-sum desc, doc asc) with
    run-sum > 0 are (vals, docs) (k,) int64, (-1, -1) past the last."""
    w = words.tolist()
    doc = [(x >> 32) >> kb for x in w]
    cand = []
    for i, x in enumerate(w):
        if doc[i] >= n_docs or (i + 1 < len(w) and doc[i + 1] == doc[i]):
            continue
        run = sum(w[i - j] & 0xFFFFFFFF for j in range(min(s, i + 1))
                  if doc[i - j] == doc[i])
        if run > 0:
            cand.append((-run, doc[i]))
    cand.sort()
    vals = [-r for r, _d in cand[:k]] + [-1] * max(0, k - len(cand))
    docs = [d for _r, d in cand[:k]] + [-1] * max(0, k - len(cand))
    return (torch.tensor(vals, dtype=torch.int64),
            torch.tensor(docs, dtype=torch.int64))
