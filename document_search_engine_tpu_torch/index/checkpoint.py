"""Index checkpoint save/load, the JAX package's v2 format.

Port of `document_search_engine_tpu/index/checkpoint.py` for one engine
(`save_engine`, `load_engine`). Layout: one directory per index —
    config.json            IndexConfig (self-describing index)
    meta.json              n_docs_total, n_segments, format_version 2,
                           the converged plan-cache layouts
    segment_<i>.npz        the host arrays and device planes of one
                           segment (np.savez_compressed)

The files are the JAX package's, key for key and dtype for dtype, so an
index saved by either package opens in the other. A device tensor is
written as its numpy copy. The port keeps no host postings, so it
writes no `post_doc`/`post_tf` and ignores them where a JAX host build
wrote them. A load serves the stored plane bits as they are: nothing is
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
        np.savez_compressed(
            os.path.join(path, f"segment_{i}.npz"),
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
            "this is a sharded checkpoint: it opens with the sharded "
            "engine's loader (DistributedSearchEngine.load), which is not "
            "ported to the torch package yet (ROADMAP A13)"
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
