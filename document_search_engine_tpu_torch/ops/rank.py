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
    workspace = None
    if c_total * 8 > lib.dse_smem_region_bytes():
        workspace = torch.empty(nq * c_total, dtype=torch.int64, device=dev)
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
