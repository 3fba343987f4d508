"""The fused search step: plan tables and the hand-written CUDA kernel.

Port of the host and XLA parts of `document_search_engine_tpu/ops/
fused_pallas.py` (key bits, compaction granule and
`expand_plan_tables`, with its doc-range piece form), plus the wrapper
of the CUDA kernel that replaces its Pallas kernel `_fused_kernel`
(with its `dlim` doc-range branch) and the rank stage of
`ops/rank_pallas.py merge_rank_body`, both its k <= 16 branch and its
k 17..128 tournament branch (csrc/fused_search.cu, csrc/rank.cuh). The
same kernel's interleaved-plane load stage serves ops/fused_dv.py. The
launch's thread count follows the bucket's region (launch_threads), and
the kernel's plan table and load stage have plain mirrors here
(load_units, load_region, placement) for the CPU tests. The heavy
buckets (ops/tiled.py tiled_route: r_c >= TILED_MIN_RC, no doc limits,
a tile block that fits) go to the tiled kernels of ops/tiled.py
instead, from the same plan tables.

The kernel library (every csrc/*.cu, the rank-only kernel of ops/rank.py,
the rerank dots of ops/rerank.py and the segment merge of
ops/segment_merge.py included) is compiled by nvcc at
first use into `_build/` next to this package, keyed by a hash of the
sources and flags, and loaded with ctypes (a plain C interface: no
PyTorch headers, a few seconds of build). `fused_search` launches it for
CUDA tensors and takes the plain PyTorch version (ops/packed.py, or the
tiled kernels' mirror in ops/tiled.py) for CPU tensors; there is no
other path.
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

# The kernel serves k <= MAX_K; larger k is the plain scorer's
# (engine/engine.py _batch_step), as in the reference. Launches at
# k <= SMALL_K count in fused_search.launches (the reference's k <= 16
# branch), larger ones in fused_search.launches_large_k.
SMALL_K = 16
MAX_K = 128

# The launch's thread count (csrc/fused_search.cu THREADS) by the
# bucket's region rows r_c: the first entry whose bound holds. Chosen per
# bucket shape on the card (PERF.md): 256 threads run 6 blocks an SM at
# r_c 16 and 3 at r_c 32 (shared memory is the limit), regions of 64
# rows and more take one block an SM and spread their merge over 1024.
THREADS_BY_RC = ((32, 256), (None, 1024))

# Buckets of r_c >= TILED_MIN_RC rows without doc limits go to the tiled
# kernels (ops/tiled.py, csrc/fused_tiled.cu): a doc-range tile's sums in
# a shared-memory accumulator instead of the merge of every pair through
# the workspace. Chosen by an A/B of both benchmark cells' buckets on the
# card (PERF.md §6): below 256 rows the fused kernel's merges are
# short, and the tiled kernels' walk over every tile of the index (some
# 0.1 ms a bucket at 8.8M docs) costs more than they save.
TILED_MIN_RC = 256

# The most dynamic shared memory a launch asks for (csrc/rank.cuh
# kSmemMaxBytes; the library's dse_smem_max_bytes()).
SMEM_MAX_BYTES = 224 * 1024


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
    offs_dev: torch.Tensor | None = None,  # (T, P+1) i32 doc quantiles
    cols: torch.Tensor | None = None,  # (nq, 2) i32 piece quantile columns
):
    """Device-side twin of the reference's host `plan_tables`: expands
    (nq, S) rows/coeff-bits into the (nq, 1, NB) srcrow/rem/abits/dstrow
    tables with int32 torch ops, bit-identical to the host planner
    (fuzz-tested against it). Per
    batch the host ships only the (nq, S) rows and coefficient bits.

    Where the reference loops over the S slots with masked selects, the
    slot owning block j is found directly, as the number of slots whose
    cumulative block count is <= j (one batched searchsorted), which
    keeps the op count independent of S.

    offs_dev/cols (doc-range splitting): each plan row is a piece of a
    query covering quantile columns [cols[q, 0], cols[q, 1]): per slot
    the record range [offs_dev[row, c0], offs_dev[row, c1]), read from
    its 128-aligned floor (the kernel's doc limits mask the head
    overlap)."""
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
    if cols is not None:
        cl = cols.long()
        lo = offs_dev[rl, cl[:, 0:1]]  # (nq, S)
        hi = offs_dev[rl, cl[:, 1:2]]
        start_al = lo - lo % LANES
        lens = hi - start_al
    else:
        start_al = 0
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
    # row starts and piece starts are both 128-aligned
    starts128 = ((row_start[rl] + start_al) // LANES).gather(1, slot_c)
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


# ------------------------------------ thread count and load-stage mirror
def launch_threads(r_c: int) -> int:
    """The thread count of a launch over regions of r_c rows
    (THREADS_BY_RC)."""
    return next(t for bound, t in THREADS_BY_RC
                if bound is None or r_c <= bound)


def plan_table_bytes(units: int) -> int:
    """csrc/fused_search.cu plan_table_bytes: the kernel's per-query plan
    table (off and q4 with units + 1 entries, src, coeff and slot with
    units), int32, rounded to 16 bytes."""
    return ((5 * units + 2) * 4 + 15) // 16 * 16


def fused_smem_bytes(r_c: int, n_blocks: int) -> int:
    """Dynamic shared memory of a launch over regions of r_c rows in
    n_blocks plan blocks: the plan table and two merge buffers of c =
    r_c * 128 pairs, capped at SMEM_MAX_BYTES."""
    c = r_c * LANES
    return min(plan_table_bytes(min(n_blocks, c)) + 16 * c, SMEM_MAX_BYTES)


def buffer_words(r_c: int, n_blocks: int) -> int:
    """The 8-byte words of that shared memory behind the plan table."""
    c = r_c * LANES
    return (fused_smem_bytes(r_c, n_blocks)
            - plan_table_bytes(min(n_blocks, c))) // 8


def placement(n: int, words: int) -> str:
    """csrc/rank.cuh place_buffers for a query of n real pairs and
    `words` words of shared memory: "shared" (both merge buffers there),
    "first" (the second in the workspace) or "workspace" (both)."""
    if 2 * n <= words:
        return "shared"
    return "first" if n <= words else "workspace"


def load_units(srcrow, rem, abits, dstrow, *, block: int, r_c: int):
    """The kernel's plan table (csrc/fused_search.cu scan_plan), per
    query: a dict of int64 numpy arrays over its units, the plan blocks
    that hold a posting, in plan order: off and q4 (units + 1 entries:
    where each unit's pairs begin in the region, and its int4 words of
    one plane in front of it; the last entry is the total), src (first
    plane row), coeff (f32 bits) and slot. A block's valid count is
    min(max(rem, 0), block), 0 when skipped, cut where the region's
    r_c * 128 pairs end."""
    c = r_c * LANES
    nq = srcrow.shape[0]
    sr, rm, ab, ds = (np.asarray(t).reshape(nq, -1).astype(np.int64)
                      for t in (srcrow, rem, abits, dstrow))
    v = np.where(sr >= 0, np.clip(rm, 0, block), 0)
    incl = np.cumsum(v, axis=1)
    at = np.minimum(incl - v, c)
    valid = np.minimum(incl, c) - at
    out = []
    for q in range(nq):
        live = valid[q] > 0
        out.append({
            "off": np.append(at[q][live], min(int(incl[q, -1]), c)
                             if incl.shape[1] else 0),
            "q4": np.concatenate([[0], np.cumsum((valid[q][live] + 3) // 4)]),
            "src": sr[q][live], "coeff": ab[q][live],
            "slot": (ds[q][live] & 0xFFFFFFFF) >> SLOT_SHIFT,
        })
    return out


def _candidates(d, v, coeff, slot, scale, clip, key_bits, dlim):
    """(key << 32) | ci int64 words of postings (docs d, value bits v,
    their units' coefficient bits and slots): csrc/fused_search.cu
    make_candidate, in f32 as ops/packed.py pack_tables computes ci."""
    a = torch.from_numpy(np.asarray(coeff, np.int32)).view(torch.float32)
    val = torch.from_numpy(np.asarray(v, np.int32)).view(torch.float32)
    ci = torch.round((a * val) * torch.tensor(scale, dtype=torch.float32))
    ci = ci.clamp(0.0, clip).to(torch.int64).numpy()
    d = np.asarray(d, np.int64)
    if dlim is not None:
        ci = np.where((d >= dlim[0]) & (d < dlim[1]), ci, 0)
    key = (d << key_bits) | np.asarray(slot, np.int64) if key_bits else d
    return (key << 32) | ci


def load_region(planes, srcrow, rem, abits, dstrow, dlim=None, *,
                block: int, r_c: int, key_bits: int, scale: float,
                clip: float):
    """What the kernel's load stage leaves for the rank stage, per query:
    (words, off), the (n,) int64 candidates (key << 32) | ci of every
    unit's real postings, each unit behind the previous one, and the
    unit offsets. planes is (post_doc, post_val) (X, 128) or (post_dv,)
    (X + 8, 256). Every int4 word g of the flattened index maps to its
    unit u (q4[u] <= g < q4[u + 1]) and to lane 4 (g - q4[u]) of the
    unit's rows, read from the two planes or from the halves of one dv
    row, as the kernel's threads do."""
    dv = len(planes) == 1
    flat = [np.asarray(p).reshape(-1) for p in planes]
    lim = None if dlim is None else np.asarray(dlim).reshape(-1, 2)
    out = []
    for q, t in enumerate(load_units(srcrow, rem, abits, dstrow,
                                     block=block, r_c=r_c)):
        off, q4, src = t["off"], t["q4"], t["src"]
        g = np.repeat(np.arange(int(q4[-1])), 4)
        lane = np.tile(np.arange(4), int(q4[-1]))
        u = np.searchsorted(q4, g, side="right") - 1
        e4 = g - q4[u]
        e = 4 * e4 + lane
        if dv:
            at = (src[u] + e4 // 32) * 2 * LANES + (e4 % 32) * 4 + lane
            last = at + LANES
        else:
            at = last = src[u] * LANES + e
        # the kernel reads whole int4 words, past a unit's valid count too
        if len(at) and int(last.max()) >= flat[0].size:
            raise IndexError(f"query {q}: an int4 read ends past the plane")
        keep = e < off[u + 1] - off[u]
        u, e, at = u[keep], e[keep], at[keep]
        if dv:
            d, v = flat[0][at], flat[0][at + LANES]
        else:
            d, v = flat[0][at], flat[1][at]
        words = np.zeros(int(off[-1]), np.int64)
        words[off[u] + e] = _candidates(
            d, v, t["coeff"][u], t["slot"][u], scale, clip, key_bits,
            None if lim is None else lim[q])
        out.append((words, off))
    return out


# ---------------------------------------------------------------- build
_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
            "nvcc not found (set CUDA_HOME): the kernels are built from "
            "csrc/ at first use on a CUDA machine"
        )
    return found


def build_kernels() -> Path:
    """Compile csrc/*.cu into one shared library (once per source hash)
    and return its path: one nvcc per source, all started together,
    then one link. The ptxas report (registers, shared memory, spills)
    is kept beside the library as <name>.log."""
    cu = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    so = BUILD_DIR / f"libdse_fused_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in cu]
    procs = [
        subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(cu, objs)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [
        f"{src.name} ({proc.returncode}):\n{log}"
        for src, proc, log in zip(cu, procs, logs) if proc.returncode
    ]
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    link = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *map(str, objs)],
        capture_output=True, text=True,
    )
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}"
        )
    so.with_suffix(".log").write_text("".join(logs) + link.stdout + link.stderr)
    os.replace(tmp, so)
    return so


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(str(build_kernels()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dse_fused_search.argtypes = [
            p, p, p, p, p, p, p,  # planes, plan tables, dlim (or None)
            i, i, i, i, i, i,  # nq, n_blocks, block, s, k, n_docs
            f, f,  # scale, clip
            i, i, i,  # r_c, key_bits, threads
            p, p, p, p,  # workspace, vals, docs, stream
        ]
        lib.dse_fused_search_dv.argtypes = [
            p, p, p, p, p,  # dv plane, plan tables
            i, i, i, i, i, i,  # nq, n_blocks, block, s, k, n_docs
            f, f,  # scale, clip
            i, i, i,  # r_c, key_bits, threads
            p, p, p, p,  # workspace, vals, docs, stream
        ]
        lib.dse_fused_blocks_per_sm.argtypes = [i, i, i, i]
        lib.dse_tiled_search.argtypes = [
            p, p, p, p, p, p,  # planes, plan tables
            i, i, i, i, i, i,  # nq, n_blocks, block, s, k, n_docs
            f, f,  # scale, clip
            i,  # r_c
            p, p, p, p,  # survivors, vals, docs, stream
        ]
        lib.dse_tiled_blocks_per_sm.argtypes = [i, i]
        lib.dse_rank.argtypes = [
            p, p,  # d_key, ci
            i, i, i, i, i, i,  # nq, c, run, s, k, n_docs
            p, p, p, p,  # workspace, vals, docs, stream
        ]
        lib.dse_rerank_dots.argtypes = [
            p, p, p, p,  # emb, ssq, qemb, gids
            i, i, i,  # nq, candidates, dim
            i, i, i,  # vec, lanes, queries a block (rerank.dots_launch)
            p, p, p,  # dots, cand_ssq, stream
        ]
        lib.dse_segment_merge.argtypes = [
            p, p,  # stacked step output, positions
            i, i, i,  # nq, segments, k
            p, p,  # out, stream
        ]
        for fn in (lib.dse_fused_search, lib.dse_fused_search_dv,
                   lib.dse_fused_blocks_per_sm, lib.dse_tiled_search,
                   lib.dse_tiled_blocks_per_sm, lib.dse_rank,
                   lib.dse_rerank_dots, lib.dse_segment_merge):
            fn.restype = i
        lib.dse_error_string.argtypes = [i]
        lib.dse_error_string.restype = ctypes.c_char_p
        for fn in (lib.dse_smem_region_bytes, lib.dse_smem_max_bytes):
            fn.argtypes = []
            fn.restype = i
        _lib_handle = lib
    return _lib_handle


def check_launch(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({_lib().dse_error_string(err).decode()})"
        )


def _check_int32(name: str, t: torch.Tensor, device, shape=None):
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")


def launch_fused(
    planes,  # (post_doc, post_val) (X, 128) planes, or (post_dv,) (X+8, 256)
    srcrow, rem, abits, dstrow, dlim, *, n_blocks, block, s, k, n_docs,
    scale, clip, r_c, key_bits,
):
    """Checks the arguments and launches the fused kernel on CUDA
    tensors (the two-plane load stage, with doc limits when dlim is
    given, or the dv load stage for one plane) with launch_threads(r_c)
    threads a block. Returns (vals, docs)."""
    dev = planes[0].device
    nq = srcrow.shape[0]
    for name, t in zip(("post_doc", "post_val"), planes):
        _check_int32(name, t, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    width = LANES if len(planes) == 2 else 2 * LANES
    if planes[0].ndim != 2 or planes[0].shape[1] != width:
        raise ValueError(
            f"plane: expected (X, {width}), got {tuple(planes[0].shape)}")
    if len(planes) == 2 and planes[1].shape != planes[0].shape:
        raise ValueError("post_val: shape differs from post_doc")
    for name, t in (
        ("srcrow", srcrow), ("rem", rem), ("abits", abits), ("dstrow", dstrow)
    ):
        _check_int32(name, t, dev, (nq, 1, n_blocks))
    if dlim is not None:
        _check_int32("dlim", dlim, dev, (nq, 1, 2))
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(
            f"k={k}: the CUDA kernel serves 1 <= k <= {MAX_K}; the "
            "engine routes larger k to the plain scorer"
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
    # two merge buffers a query; the kernel takes a query's slice only
    # when its real postings do not fit shared memory
    workspace = None
    if r_c * LANES * 8 > lib.dse_smem_region_bytes():
        workspace = torch.empty(nq * 2 * r_c * LANES, dtype=torch.int64,
                                device=dev)
    tail = (
        nq, n_blocks, block, s, k, n_docs, scale, clip, r_c, key_bits,
        launch_threads(r_c),
        None if workspace is None else workspace.data_ptr(),
        vals.data_ptr(), docs.data_ptr(),
    )
    tables = [t.data_ptr() for t in (srcrow, rem, abits, dstrow)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if len(planes) == 2:
            err = lib.dse_fused_search(
                planes[0].data_ptr(), planes[1].data_ptr(), *tables,
                None if dlim is None else dlim.data_ptr(), *tail, stream,
            )
        else:
            err = lib.dse_fused_search_dv(
                planes[0].data_ptr(), *tables, *tail, stream
            )
    check_launch("fused_search", err)
    return vals, docs


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
    dlim: torch.Tensor | None = None,  # (nq, 1, 2) i32 [d_lo, d_hi)
):
    """(vals, docs_local) (nq, k) int32 ranked (score desc, doc asc);
    (-1, -1) for exhausted slots. Every query must fit its compacted
    blocks in r_c rows (the bucketed planner guarantees it). dlim
    (doc-range splitting): per plan row, postings whose doc lies outside
    [d_lo, d_hi) contribute nothing.

    A bucket that ops/tiled.py tiled_route takes (r_c >= TILED_MIN_RC,
    no dlim, a tile block that fits) goes to ops/tiled.py tiled_search:
    the tiled kernels on CUDA tensors, their plain mirror on CPU tensors.
    Every other bucket: CUDA tensors launch the fused kernel on the
    current stream; CPU tensors take the plain version (ops/packed.py
    search_packed_tables), which ignores dstrow, r_c and key_bits — they
    only shape the kernel's buffer, not the result.

    On CUDA tensors each call counts one launch of the kernel it ran: in
    fused_search.launches_tiled for the tiled kernels; for the fused
    kernel in fused_search.launches_dlim when dlim is given, else in
    fused_search.launches for k <= 16 and fused_search.launches_large_k
    for 16 < k <= 128."""
    from .tiled import tiled_route, tiled_search

    dev = post_doc.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_search: unsupported device {dev}")
    tiled = tiled_route(mode="fused", k=k, split=dlim is not None, r_c=r_c,
                        n_blocks=n_blocks, s=s)
    if tiled:
        out = tiled_search(
            post_doc, post_val, srcrow, rem, abits, dstrow,
            n_blocks=n_blocks, block=block, s=s, k=k, n_docs=n_docs,
            scale=scale, clip=clip, r_c=r_c,
        )
    elif dev.type == "cpu":
        from .packed import search_packed_tables

        out = search_packed_tables(
            post_doc, post_val, srcrow, rem, abits, scale, clip, 0,
            n_blocks=n_blocks, block=block, s=s, k=k, n_docs=n_docs,
            dlim=dlim,
        )
    else:
        out = launch_fused(
            (post_doc, post_val), srcrow, rem, abits, dstrow, dlim,
            n_blocks=n_blocks, block=block, s=s, k=k, n_docs=n_docs,
            scale=scale, clip=clip, r_c=r_c, key_bits=key_bits,
        )
    if dev.type == "cpu":
        return out
    if tiled:
        fused_search.launches_tiled += 1
    elif dlim is not None:
        fused_search.launches_dlim += 1
    elif k <= SMALL_K:
        fused_search.launches += 1
    else:
        fused_search.launches_large_k += 1
    return out


fused_search.launches = 0
fused_search.launches_large_k = 0
fused_search.launches_dlim = 0
fused_search.launches_tiled = 0
fused_search.launches_dv = 0  # counted by ops/fused_dv.py fused_search_dv
