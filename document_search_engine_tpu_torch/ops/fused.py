"""The fused search step: plan tables and the hand-written CUDA kernel.

Port of the host and XLA parts of `document_search_engine_tpu/ops/
fused_pallas.py` (key bits, compaction granule and
`expand_plan_tables`), plus the wrapper of the CUDA kernel that replaces
its Pallas kernel `_fused_kernel` and the k <= 16 rank stage of
`ops/rank_pallas.py merge_rank_body` (csrc/fused_search.cu, csrc/rank.cuh).

The kernel library is compiled by nvcc at first use into `_build/` next
to this package, keyed by a hash of the sources and flags, and loaded
with ctypes (a plain C interface: no PyTorch headers, a few seconds of
build). `fused_search` launches it for CUDA tensors and takes the plain
PyTorch version (ops/packed.py) for CPU tensors; there is no other path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..index.csr import NNZ_SLICE_MARGIN

LANES = 128

# Candidate-buffer compaction granularity, in 128-lane rows: each plan
# block's real postings are stored at a per-query running row offset
# (the dstrow plan table), so the rank stage runs over ~ceil(real
# postings / 128) rows instead of n_blocks * block / 128.
GRANULE_ROWS = 1

# Unique candidate keys: the kernel sorts (doc << kb) | slot, and the
# slot id reaches it in dstrow bits SLOT_SHIFT+ (destination rows are
# < 2^24 by construction — asserted).
SLOT_SHIFT = 24
DST_MASK = (1 << SLOT_SHIFT) - 1

# The kernel keeps top-k in registers per thread (csrc/rank.cuh kMaxK);
# larger k is ROADMAP item A9.
MAX_K = 16


def key_bits_for(s: int, n_docs: int) -> int:
    """Key shift for unique candidate keys: ceil(log2(s)) bits of slot
    id below the doc id, or 0 when the key space would overflow int32
    (the sentinel n_docs << kb is the largest key)."""
    kb = max(1, int(np.ceil(np.log2(max(s, 2)))))
    if (n_docs << kb) >= 2**31:
        return 0
    return kb


def _compact_rows(rem: torch.Tensor, block: int) -> torch.Tensor:
    """Per-block compacted row count from a rem table: real postings in
    the block, granule-rounded up."""
    g = GRANULE_ROWS * LANES
    valid = rem.clamp(0, block)
    return (-(-valid // g)).to(torch.int32) * GRANULE_ROWS


def expand_plan_tables(
    row_start: torch.Tensor,  # (T,) i32 aligned flat record offsets
    indptr: torch.Tensor,  # (T+1,) i32 true cumulative lengths
    rows: torch.Tensor,  # (nq, S) i32 term rows per slot
    cbits: torch.Tensor,  # (nq, S) i32 bitcast-f32 slot coefficients
    n_blocks: int,
    block: int,
):
    """Device-side twin of the reference's host `plan_tables`: expands
    (nq, S) rows/coeff-bits into the (nq, 1, NB) srcrow/rem/abits/dstrow
    tables with int32 torch ops, bit-identical to the host planner
    (fuzz-tested against it). Per
    batch the host ships only the (nq, S) rows and coefficient bits.

    Where the reference loops over the S slots with masked selects, the
    slot owning block j is found directly, as the number of slots whose
    cumulative block count is <= j (one batched searchsorted), which
    keeps the op count independent of S."""
    assert block <= NNZ_SLICE_MARGIN, (
        f"block={block} exceeds the builder's slice margin "
        f"({NNZ_SLICE_MARGIN}); tail blocks would read out of bounds"
    )
    nq, s = rows.shape
    b128 = block // LANES
    dev = rows.device
    if int(row_start.shape[0]) == 0:  # empty segment: every block skipped
        z = torch.zeros((nq, 1, n_blocks), dtype=torch.int32, device=dev)
        sr = torch.full((nq, 1, n_blocks), -1, dtype=torch.int32, device=dev)
        return sr, z, z.clone(), z.clone()
    coeff = cbits.view(torch.float32)
    rl = rows.long()
    lens = indptr[rl + 1] - indptr[rl]
    lens = torch.where(coeff > 0, lens, torch.zeros_like(lens))
    nblk = -(-lens // block)
    blk_end = torch.cumsum(nblk, dim=1).to(torch.int32)  # (nq, S)
    jj = torch.arange(n_blocks, dtype=torch.int32, device=dev)
    jj = jj.expand(nq, n_blocks).contiguous()
    # owning slot of block j: #slots whose blocks all end at or before j
    slot = torch.searchsorted(blk_end, jj, right=True).to(torch.int32)
    used = slot < s
    slot_c = slot.clamp(max=s - 1).long()
    blk_start = (blk_end - nblk).gather(1, slot_c)
    off_b = jj - blk_start
    starts128 = (row_start[rl] // LANES).gather(1, slot_c)
    neg = torch.full_like(off_b, -1)
    zero = torch.zeros_like(off_b)
    srcrow = torch.where(used, starts128 + off_b * b128, neg)
    rem = torch.where(used, lens.gather(1, slot_c) - off_b * block, zero)
    abits = torch.where(used, cbits.gather(1, slot_c), zero)
    slotno = torch.where(used, slot, zero)
    crows = _compact_rows(rem, block)
    dstrow = (torch.cumsum(crows, dim=1) - crows).to(torch.int32)
    assert n_blocks * b128 <= DST_MASK and s <= 1 << (31 - SLOT_SHIFT)
    dstrow = dstrow | (slotno << SLOT_SHIFT)
    return (
        srcrow.reshape(nq, 1, n_blocks),
        rem.reshape(nq, 1, n_blocks),
        abits.reshape(nq, 1, n_blocks),
        dstrow.reshape(nq, 1, n_blocks),
    )


# ---------------------------------------------------------------- build
_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # bit parity: no mul+add pair may be contracted into an FMA
    "--fmad=false",
    "-Xptxas", "-v",
)

_lib_handle = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError(
            "nvcc not found (set CUDA_HOME): the fused search kernel is "
            "built from csrc/ at first use on a CUDA machine"
        )
    return found


def build_kernels() -> Path:
    """Compile csrc/*.cu into a shared library (once per source hash)
    and return its path. The ptxas report (registers, shared memory,
    spills) is kept beside it as <name>.log."""
    cu = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    so = BUILD_DIR / f"libdse_fused_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(str(build_kernels()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dse_fused_search.argtypes = [
            p, p, p, p, p, p,  # planes and plan tables
            i, i, i, i, i, i,  # nq, n_blocks, block, s, k, n_docs
            ctypes.c_float, ctypes.c_float,  # scale, clip
            i, i,  # r_c, key_bits
            p, p, p, p,  # workspace, vals, docs, stream
        ]
        lib.dse_fused_search.restype = i
        lib.dse_error_string.argtypes = [i]
        lib.dse_error_string.restype = ctypes.c_char_p
        lib.dse_smem_region_bytes.argtypes = []
        lib.dse_smem_region_bytes.restype = i
        _lib_handle = lib
    return _lib_handle


def _check_int32(name: str, t: torch.Tensor, device, shape=None):
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")


def fused_search(
    post_doc: torch.Tensor,  # (X, 128) i32 aligned doc plane
    post_val: torch.Tensor,  # (X, 128) i32 aligned bitcast-f32 val plane
    srcrow: torch.Tensor,  # (nq, 1, NB) i32 plan tables
    rem: torch.Tensor,
    abits: torch.Tensor,
    dstrow: torch.Tensor,
    *,
    n_blocks: int,
    block: int,
    s: int,
    k: int,
    n_docs: int,
    scale: float,  # f32(2^scale_bits) as a Python float
    clip: float,  # f32 per-contribution clip as a Python float
    r_c: int,  # compacted region rows per query (pow2)
    key_bits: int,  # unique-key shift (key_bits_for), 0 = plain doc keys
):
    """(vals, docs_local) (nq, k) int32 ranked (score desc, doc asc);
    (-1, -1) for exhausted slots. Every query must fit its compacted
    blocks in r_c rows (the bucketed planner guarantees it).

    CUDA tensors launch the kernel on the current stream (and count one
    launch in fused_search.launches); CPU tensors take the plain version
    (ops/packed.py search_packed_tables), which ignores dstrow, r_c and
    key_bits — they only shape the kernel's buffer, not the result."""
    dev = post_doc.device
    if dev.type == "cpu":
        from .packed import search_packed_tables

        return search_packed_tables(
            post_doc, post_val, srcrow, rem, abits, scale, clip, 0,
            n_blocks=n_blocks, block=block, s=s, k=k, n_docs=n_docs,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_search: unsupported device {dev}")
    nq = srcrow.shape[0]
    _check_int32("post_doc", post_doc, dev)
    _check_int32("post_val", post_val, dev, post_doc.shape)
    if post_doc.ndim != 2 or post_doc.shape[1] != LANES:
        raise ValueError(f"post_doc: expected (X, {LANES}), got {post_doc.shape}")
    for name, t in (
        ("srcrow", srcrow), ("rem", rem), ("abits", abits), ("dstrow", dstrow)
    ):
        _check_int32(name, t, dev, (nq, 1, n_blocks))
    if post_doc.data_ptr() % 16 or post_val.data_ptr() % 16:
        raise ValueError("posting planes must be 16-byte aligned")
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(
            f"k={k}: the CUDA kernel serves 1 <= k <= {MAX_K}; "
            "larger k is ROADMAP item A9"
        )
    if r_c < 1 or r_c & (r_c - 1):
        raise ValueError(f"r_c={r_c} must be a power of two")
    if block % LANES or not LANES <= block <= NNZ_SLICE_MARGIN:
        raise ValueError(f"block={block}: a multiple of {LANES} up to "
                         f"{NNZ_SLICE_MARGIN}")
    if not 1 <= s <= 1 << (31 - SLOT_SHIFT):
        raise ValueError(f"s={s} out of range")
    if key_bits < 0 or (n_docs << key_bits) >= 2**31 or (
        key_bits and s > 1 << key_bits
    ):
        raise ValueError(f"key_bits={key_bits} invalid for s={s}, "
                         f"n_docs={n_docs}")
    vals = torch.empty((nq, k), dtype=torch.int32, device=dev)
    docs = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return vals, docs
    lib = _lib()
    region_bytes = r_c * LANES * 8
    workspace = None
    if region_bytes > lib.dse_smem_region_bytes():
        workspace = torch.empty(nq * r_c * LANES, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dse_fused_search(
            post_doc.data_ptr(), post_val.data_ptr(), srcrow.data_ptr(),
            rem.data_ptr(), abits.data_ptr(), dstrow.data_ptr(),
            nq, n_blocks, block, s, k, n_docs, scale, clip, r_c, key_bits,
            None if workspace is None else workspace.data_ptr(),
            vals.data_ptr(), docs.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_search launch failed: CUDA error {err} "
            f"({lib.dse_error_string(err).decode()})"
        )
    fused_search.launches += 1
    return vals, docs


fused_search.launches = 0
