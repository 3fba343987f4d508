"""The `docs` mesh of the sharded engine: one process, a list of torch
devices.

Port of `document_search_engine_tpu/parallel/mesh.py`. The reference is
single-controller: one Python process drives every device of a 1-D
`docs` mesh through shard_map. Here one process drives a tuple of torch
devices, shard i living on `devices[i]`, and the two collectives the
engine needs are explicit functions. A device may repeat: several
shards share one card (or the CPU) exactly as they would share a mesh
of their own, so one card serves any shard count. On a machine with
several cards the same code places the shards on `cuda:0..n-1` and the
collectives become peer copies.

A mesh never mixes the CPU with CUDA, and asking for the card without
CUDA raises: nothing falls back to the CPU unless it was asked for by
name.
"""
from __future__ import annotations

import torch

DOCS_AXIS = "docs"


class Mesh:
    """A 1-D `docs` mesh: `devices[i]` holds shard i (repeats allowed)."""

    axis_names = (DOCS_AXIS,)

    def __init__(self, devices):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type not in ("cpu", "cuda"):
                raise ValueError(f"unsupported mesh device {d}")
            if d.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        f"mesh device {d}: CUDA is not available on this "
                        "machine"
                    )
                if d.index is None:
                    d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) > 1:
            raise ValueError(
                f"a mesh may not mix the CPU and CUDA devices: {devs}"
            )
        self.devices = tuple(devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """Each device once, in the order of its first shard."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def dst(self) -> torch.device:
        """Where the collectives land: shard 0's device."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_shards: int | None = None, device=None) -> Mesh:
    """A mesh of n_shards shards. device None or "cuda" lays them over
    the visible cards in contiguous runs (one card: every shard on
    cuda:0), one shard a card when n_shards is None; a device with an
    index ("cuda:1") or "cpu" holds every shard (one when n_shards is
    None)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"make_mesh(device={str(dev)!r}): CUDA is not available on this "
            "machine"
        )
    if dev.type == "cuda" and dev.index is None:
        n_cards = torch.cuda.device_count()
        n = n_cards if n_shards is None else n_shards
        if n < 1:
            raise ValueError(f"n_shards={n_shards} must be >= 1")
        return Mesh(
            [torch.device("cuda", i * n_cards // n) for i in range(n)]
        )
    n = 1 if n_shards is None else n_shards
    if n < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    return Mesh([dev] * n)


def all_gather(tensors, dst: torch.device) -> torch.Tensor:
    """The per-shard tensors (equal shapes) stacked on `dst` along a new
    leading axis, shard order: a copy to dst where a shard lives
    elsewhere, then one concatenation."""
    return torch.stack([t.to(dst) for t in tensors])


def psum(tensors, dst: torch.device) -> torch.Tensor:
    """The elementwise sum over shards of integer tensors (equal shapes),
    on `dst`. Only integer sums: they are exact in any order."""
    if any(t.is_floating_point() for t in tensors):
        raise TypeError("psum sums integer tensors only")
    out = tensors[0].to(dst, copy=True)
    for t in tensors[1:]:
        out += t.to(dst)
    return out
