"""The fused search step over one interleaved doc|value plane.

Port of `document_search_engine_tpu/ops/fused_dv.py`: `interleave_planes`
and the wrapper of its Pallas kernel `_fused_dv_kernel` (:119), which is
replaced by the dv load stage of the fused CUDA kernel
(csrc/fused_search.cu, Load::kDv): one load stream over a (X + 8, 256)
plane whose row r holds the docs of the (X, 128) doc plane's row r in
lanes [0, 128) and its values in [128, 256). Plan tables, compaction and
the rank stage are the two-plane kernel's.

The TPU kernel's 8-row aligned overhang (a Mosaic DMA rule) has no
counterpart here; the plane keeps its 8 zero pad rows, so it is the
reference's bit for bit. CUDA tensors launch the kernel; CPU tensors
take the plain version, `search_packed_tables` on the plane's halves.
"""
from __future__ import annotations

import torch

from .fused import LANES, fused_search, launch_fused

ALIGN_ROWS = 8  # the reference's zero pad rows under the plane


def interleave_planes(post_doc: torch.Tensor, post_val: torch.Tensor):
    """(X + 8, 256) int32 dv plane: lanes [0, 128) the doc keys, [128,
    256) the bitcast-f32 values, the source planes' row indexing, and 8
    zero rows below."""
    dv = torch.cat([post_doc, post_val], dim=1)
    return torch.nn.functional.pad(dv, (0, 0, 0, ALIGN_ROWS))


def fused_search_dv(
    post_dv: torch.Tensor,  # (X + 8, 256) i32 interleaved doc|val plane
    srcrow: torch.Tensor,  # (nq, 1, NB) i32 plan tables (ops/fused.py)
    rem: torch.Tensor,
    abits: torch.Tensor,
    dstrow: torch.Tensor,
    *,
    n_blocks: int,
    block: int,
    s: int,
    k: int,
    n_docs: int,
    scale: float,
    clip: float,
    r_c: int,
    key_bits: int,
):
    """fused_search over the dv plane: the same plan tables, arguments
    and outputs, (vals, docs_local) (nq, k) int32. CUDA tensors count one
    launch in fused_search.launches_dv; CPU tensors take
    fused_search_dv_plain."""
    dev = post_dv.device
    if dev.type == "cpu":
        return fused_search_dv_plain(
            post_dv, srcrow, rem, abits, n_blocks=n_blocks, block=block,
            s=s, k=k, n_docs=n_docs, scale=scale, clip=clip,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_search_dv: unsupported device {dev}")
    out = launch_fused(
        (post_dv,), srcrow, rem, abits, dstrow, None, n_blocks=n_blocks,
        block=block, s=s, k=k, n_docs=n_docs, scale=scale, clip=clip,
        r_c=r_c, key_bits=key_bits,
    )
    fused_search.launches_dv += 1
    return out


def fused_search_dv_plain(
    post_dv: torch.Tensor, srcrow, rem, abits, *, n_blocks: int, block: int,
    s: int, k: int, n_docs: int, scale: float, clip: float,
):
    """The plain version of fused_search_dv: search_packed_tables on the
    plane's doc and value halves (the same (vals, docs_local))."""
    from .packed import search_packed_tables

    body = post_dv[:-ALIGN_ROWS]
    return search_packed_tables(
        body[:, :LANES], body[:, LANES:], srcrow, rem, abits, scale, clip, 0,
        n_blocks=n_blocks, block=block, s=s, k=k, n_docs=n_docs,
    )
