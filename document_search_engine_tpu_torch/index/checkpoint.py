"""Index checkpoint save/load, the JAX package's v2 format.

Port of `document_search_engine_tpu/index/checkpoint.py`, for one
engine (`save_engine`, `load_engine`) and for the sharded one
(`save_sharded`, `load_sharded`). Layout: one directory per index —
    config.json            IndexConfig (self-describing index)
    meta.json              n_docs_total, n_segments, format_version 2,
                           the converged plan-cache layouts; a sharded
                           index: n_shards, "sharded": true
    segment_<i>.npz        the host arrays and device planes of one
                           segment (np.savez_compressed)
    shard_<i>.npz          the host arrays of one shard (its device
                           planes are derived on load, for any mesh)

The files are the JAX package's, key for key and dtype for dtype, so an
index saved by either package opens in the other. A device tensor is
written as its numpy copy; a host-built segment's or shard's host
postings (`post_doc`/`post_tf`; `host_post_doc`/`host_post_tf` in a
shard) are written when it has them, as the JAX package does. A
single-engine load serves the stored plane bits as they are: nothing is
re-derived.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

FORMAT_VERSION = 2  # 128-aligned (X, 128) posting planes


def save_engine(engine, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(engine.config.to_json())
    meta = {
        "n_docs_total": engine.n_docs_total,
        "n_segments": len(engine.segments),
        "format_version": FORMAT_VERSION,
    }
    # converged plan layouts ride along: a loaded index replays its
    # serving traffic with zero layout grows
    if engine.plan_cache is not None:
        meta["plan_layouts"] = engine.plan_cache.to_jsonable()
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    for i, (host, dev_seg) in enumerate(engine.segments):
        arrays = dict(
            term_hash=host.term_hash,
            df=host.df,
            doc_base=np.int64(host.doc_base),
            n_docs=np.int64(host.n_docs),
            dl=host.dl,
            alive=host.alive,
            doc_hashes=host.doc_hashes,
            doc_tfs=host.doc_tfs,
            doc_ptr=host.doc_ptr,
            indptr=host.indptr,
            row_start=host.row_start,
            plane_doc=dev_seg.post_doc.cpu().numpy(),
            plane_val=dev_seg.post_val.cpu().numpy(),
            plane_tf=dev_seg.post_tf.cpu().numpy(),
            dev_dl=dev_seg.dl.cpu().numpy(),
            dev_alive=dev_seg.alive.cpu().numpy(),
            dev_inv_norm=dev_seg.inv_norm.cpu().numpy(),
        )
        # a device-built segment keeps no host postings (the planes
        # above hold them); a host-built one writes its copies
        if host.post_doc is not None:
            arrays["post_doc"] = host.post_doc
            arrays["post_tf"] = host.post_tf
        np.savez_compressed(os.path.join(path, f"segment_{i}.npz"), **arrays)


def _save_host(host, fname: str) -> None:
    arrays = dict(
        term_hash=host.term_hash,
        df=host.df,
        doc_base=np.int64(host.doc_base),
        n_docs=np.int64(host.n_docs),
        dl=host.dl,
        alive=host.alive,
        doc_hashes=host.doc_hashes,
        doc_tfs=host.doc_tfs,
        doc_ptr=host.doc_ptr,
        indptr=host.indptr,
    )
    # device-built shards keep no host postings copies; the loader
    # rebuilds them from the analyzed doc arrays (fully derivable)
    if host.post_doc is not None:
        arrays["host_post_doc"] = host.post_doc
        arrays["host_post_tf"] = host.post_tf
    np.savez_compressed(fname, **arrays)


def _load_host(fname: str):
    from . import builder
    from .csr import SegmentHost

    with np.load(fname) as z:
        if "host_post_doc" not in z.files:
            # device-built shard: re-derive the host CSR from the
            # analyzed docs (the same lexsort as the original pack)
            a = builder.AnalyzedDocs(
                hashes=z["doc_hashes"],
                tfs=z["doc_tfs"],
                doc_ptr=z["doc_ptr"],
                dl=z["dl"],
            )
            h = builder.build_host_segment(a, int(z["doc_base"]))
            h.alive[:] = z["alive"]
            builder.recompute_alive_df(h)
            return h
        return SegmentHost(
            term_hash=z["term_hash"],
            df=z["df"],
            doc_base=int(z["doc_base"]),
            n_docs=int(z["n_docs"]),
            dl=z["dl"],
            alive=z["alive"],
            doc_hashes=z["doc_hashes"],
            doc_tfs=z["doc_tfs"],
            doc_ptr=z["doc_ptr"],
            indptr=z["indptr"],
            post_doc=z["host_post_doc"],
            post_tf=z["host_post_tf"],
        )


def save_sharded(engine, path: str) -> None:
    """Checkpoint a DistributedSearchEngine: config, meta and one
    host-metadata npz per shard (the device planes are fully derivable:
    assemble_sharded rebuilds them on load, for any mesh size)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(engine.config.to_json())
    hosts = engine.index.hosts if engine.index else []
    meta = {"n_shards": len(hosts), "sharded": True,
            "format_version": FORMAT_VERSION}
    # converged plan layouts (see save_engine); their keys hold the shard
    # count and the padded geometry, so on another mesh they never match
    if engine.plan_cache is not None:
        meta["plan_layouts"] = engine.plan_cache.to_jsonable()
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    for i, h in enumerate(hosts):
        _save_host(h, os.path.join(path, f"shard_{i}.npz"))


def load_sharded(path: str, mesh=None):
    """Reopen a sharded checkpoint on `mesh` (None: make_mesh(), the
    card), elastically resharding when the mesh size differs from the
    saved shard count: docs are re-partitioned into contiguous global-id
    ranges, alive flags carry over, and df is recounted over alive docs,
    so results are bit-identical across shard counts (tested)."""
    from ..config import IndexConfig
    from ..parallel.dist import DistributedSearchEngine, assemble_sharded
    from ..parallel.mesh import make_mesh

    with open(os.path.join(path, "config.json")) as f:
        config = IndexConfig.from_json(f.read())
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format_version", 0) != FORMAT_VERSION or not meta.get(
        "sharded"
    ):
        raise ValueError(
            "not a sharded checkpoint (open with SearchEngine.load?)"
        )
    hosts = [
        _load_host(os.path.join(path, f"shard_{i}.npz"))
        for i in range(int(meta["n_shards"]))
    ]
    engine = DistributedSearchEngine(config, mesh=mesh or make_mesh())
    if not hosts:  # checkpoint of a never-built engine
        return engine
    n_shards = engine.mesh.size
    if n_shards != len(hosts):
        hosts = _reshard_hosts(hosts, n_shards)
    engine.index = assemble_sharded(hosts, config, engine.mesh)
    if meta.get("plan_layouts") and engine.plan_cache is not None:
        engine.plan_cache.load_jsonable(meta["plan_layouts"])
    return engine


def _reshard_hosts(hosts, n_shards: int):
    """Re-split contiguous doc ranges across a new shard count."""
    from . import builder

    hosts = sorted(hosts, key=lambda h: h.doc_base)
    hashes = np.concatenate([h.doc_hashes for h in hosts])
    tfs = np.concatenate([h.doc_tfs for h in hosts])
    dl = np.concatenate([h.dl for h in hosts])
    alive = np.concatenate([h.alive for h in hosts])
    ptr_parts = [np.zeros(1, np.int64)]
    acc = 0
    for h in hosts:
        ptr_parts.append(h.doc_ptr[1:] + acc)
        acc += int(h.doc_ptr[-1])
    doc_ptr = np.concatenate(ptr_parts)
    n_docs = len(dl)
    per = -(-n_docs // n_shards) if n_docs else 1
    out = []
    for i in range(n_shards):
        lo, hi = min(i * per, n_docs), min((i + 1) * per, n_docs)
        a = builder.AnalyzedDocs(
            hashes=hashes[doc_ptr[lo] : doc_ptr[hi]],
            tfs=tfs[doc_ptr[lo] : doc_ptr[hi]],
            doc_ptr=doc_ptr[lo : hi + 1] - doc_ptr[lo],
            dl=dl[lo:hi],
        )
        h = builder.build_host_segment(a, lo)
        h.alive[:] = alive[lo:hi]
        builder.recompute_alive_df(h)
        out.append(h)
    return out


def _device_geometry(indptr: np.ndarray, row_start: np.ndarray,
                     x_rows: int):
    """The device build's indptr (t_cap + 1,) and row_start (t_cap,)
    from the stored true prefixes: padded to t_cap = shape_bucket(T + 1)
    rows, indptr with its last value and row_start with one past the
    plane, as builder.build_segment_device leaves them. So a loaded
    segment holds the saved segment's device arrays, bytes included."""
    from .builder import LANES, shape_bucket

    n_terms = len(row_start)
    t_cap = shape_bucket(n_terms + 1)
    ip = np.full(t_cap + 1, indptr[-1], np.int32)
    ip[: n_terms + 1] = indptr
    rs = np.full(t_cap, x_rows * LANES, np.int32)
    rs[:n_terms] = row_start
    return ip, rs


def load_engine(path: str, engine_cls=None, device=None):
    from ..config import IndexConfig
    from .csr import SegmentDevice, SegmentHost

    if engine_cls is None:
        from ..engine.engine import SearchEngine as engine_cls

    with open(os.path.join(path, "config.json")) as f:
        config = IndexConfig.from_json(f.read())
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format_version", 0) != FORMAT_VERSION:
        raise ValueError(
            f"unsupported index format_version {meta.get('format_version')}"
        )
    if meta.get("sharded"):
        raise ValueError(
            "this is a sharded checkpoint — open it with "
            "DistributedSearchEngine.load"
        )
    engine = engine_cls(config, device=device)
    dev = engine.device

    def tensor(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    segments = []
    for i in range(int(meta["n_segments"])):
        with np.load(os.path.join(path, f"segment_{i}.npz")) as z:
            host = SegmentHost(
                term_hash=z["term_hash"],
                df=z["df"],
                doc_base=int(z["doc_base"]),
                n_docs=int(z["n_docs"]),
                dl=z["dl"],
                alive=z["alive"],
                doc_hashes=z["doc_hashes"],
                doc_tfs=z["doc_tfs"],
                doc_ptr=z["doc_ptr"],
                indptr=z["indptr"],
                row_start=z["row_start"],
                post_doc=z["post_doc"] if "post_doc" in z.files else None,
                post_tf=(
                    z["post_tf"].astype(np.int32)
                    if "post_tf" in z.files
                    else None
                ),
            )
            plane_doc = z["plane_doc"]
            indptr_d, row_start_d = _device_geometry(
                host.indptr, host.row_start, plane_doc.shape[0]
            )
            dev_seg = SegmentDevice(
                indptr=tensor(indptr_d, np.int32),
                row_start=tensor(row_start_d, np.int32),
                post_doc=tensor(plane_doc, np.int32),
                post_val=tensor(z["plane_val"], np.int32),
                post_tf=tensor(z["plane_tf"], np.int32),
                dl=tensor(z["dev_dl"], np.float32),
                alive=tensor(z["dev_alive"], np.bool_),
                inv_norm=tensor(z["dev_inv_norm"], np.float32),
            )
        segments.append([host, dev_seg])
    engine.load_segments(segments)
    if engine.n_docs_total != int(meta["n_docs_total"]):
        raise ValueError(
            f"checkpoint meta says {meta['n_docs_total']} docs, its "
            f"segments hold {engine.n_docs_total}"
        )
    if meta.get("plan_layouts") and engine.plan_cache is not None:
        engine.plan_cache.load_jsonable(meta["plan_layouts"])
    return engine
