"""State carried across: a reference (JAX) engine's segment as a port
segment, and a reference sharded index's hosts as a port ShardedIndex.

The reference's device arrays reach this module only as numpy copies
(`np.asarray` of each SegmentDevice field, made by the caller), so the
port never sees a jax array. The layouts are identical — (X, 128) int32
planes, int32 indptr/row_start, f32 dl/inv_norm, bool alive — so the
conversion is a copy to the torch device and nothing else. A sharded
index is carried by its hosts alone (numpy fields, as a sharded
checkpoint carries it) and assembled on the port's mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from .csr import SegmentDevice, SegmentHost

DEVICE_FIELDS = (
    "indptr", "row_start", "post_doc", "post_val", "post_tf", "dl",
    "alive", "inv_norm",
)
HOST_FIELDS = (
    "term_hash", "df", "doc_base", "n_docs", "dl", "alive", "doc_hashes",
    "doc_tfs", "doc_ptr", "indptr", "row_start", "post_doc", "post_tf",
)
_DTYPES = {
    "indptr": np.int32, "row_start": np.int32, "post_doc": np.int32,
    "post_val": np.int32, "post_tf": np.int32, "dl": np.float32,
    "alive": np.bool_, "inv_norm": np.float32,
}


def segment_from_reference(host, arrays: dict, device) -> tuple:
    """(SegmentHost, SegmentDevice) of the port from a reference segment:
    `host` is the reference's SegmentHost (numpy fields, copied, a host
    build's posting copies included), and `arrays` maps each
    SegmentDevice field name to its numpy copy."""
    missing = [f for f in DEVICE_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"segment arrays missing {missing}")
    port_host = host_from_reference(host)
    tensors = {}
    for f in DEVICE_FIELDS:
        a = np.asarray(arrays[f])
        if a.dtype != _DTYPES[f]:
            raise TypeError(f"{f}: expected {np.dtype(_DTYPES[f])}, got {a.dtype}")
        # np.array copies: the port owns its arrays (jax's are read-only)
        tensors[f] = torch.from_numpy(np.array(a, order="C")).to(device)
    return port_host, SegmentDevice(**tensors)


def host_from_reference(host) -> SegmentHost:
    """The port's SegmentHost with a copy of each numpy field of a
    reference SegmentHost (None stays None)."""
    return SegmentHost(
        **{
            f: (np.copy(v) if isinstance(v, np.ndarray) else v)
            for f in HOST_FIELDS
            for v in (getattr(host, f),)
        }
    )


def sharded_from_reference(hosts, config, mesh):
    """The port's ShardedIndex on `mesh` from a reference ShardedIndex's
    per-shard hosts (their numpy SegmentHost fields), through
    assemble_sharded: the state a sharded checkpoint carries, assembled
    with the host's spec-exact values."""
    from ..parallel.dist import assemble_sharded

    return assemble_sharded(
        [host_from_reference(h) for h in hosts], config, mesh
    )
