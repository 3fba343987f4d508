"""The compiled batch step: one CUDA graph per static plan.

The port's counterpart of `jax.jit` on the JAX package's batch step. The
JAX package compiles `_batch_step` once per plan, with the plan, k,
scale, clip, mode, n_real and split_p as static arguments
(`document_search_engine_tpu/engine/engine.py:40-47`), and the sharded
step as one jitted shard_map program (`parallel/dist.py:532-539`); a
batch is then one dispatch of a resident executable, its inputs handed
over by `jnp.asarray`. Here each engine on the card keeps a `StepGraphs`
that maps a key to one captured `torch.cuda.CUDAGraph`, its static input
buffers and its static output, and replays it for every batch whose key
it has seen.

- The key (`StepKey`, `step_key`): JAX's static arguments, whether the
  step merges the segments' lists on the device (engine.py
  _device_merges; the JAX package merges on the host), the shapes
  and types of the batch's inputs (the stacked rows, the coefficient
  bits and, when splitting, the pieces' quantile columns), and the
  addresses and shapes of the resident tensors the step reads (planes,
  row tables, dv planes, quantile tables) with the doc bases, so that a
  graph never serves tensors it was not captured on.
- Capture, on a key's first sighting, as jit compiles on its first call:
  the kernel library is built (ops/fused.py build_kernels) if it is not;
  the eager step runs once on a side stream (torch's warm-up rule for
  capture), and its output answers this batch; then, once the card is
  idle and the allocator's unused cache is freed (cuda_capture), the
  step is captured on the same side stream into the engine's graph pool
  (one `torch.cuda.graph_pool_handle()` per engine). A capture thus
  waits on the card; a replay does not. The k > 128 plain route (a
  stable sort and a top-k) has no data-dependent shape, so it is
  captured like the kernels' routes.
- Replay, on the caller's current stream: the batch's inputs go from
  pinned host memory into the static inputs with `non_blocking=True`,
  the graph replays, and its static output is copied into a fresh
  tensor. That copy lets batches stay in flight without sharing a
  buffer: without it the next replay would overwrite this batch's output
  before its device->host read. Nothing here waits on the card, so a
  dispatch returns while earlier batches still run.
- One pool for all of an engine's live graphs is safe because every
  replay and its copy-out run on one stream (a dispatch on another
  stream is first ordered after the last one), and nothing in the pool
  is read after its replay's copy-out: a graph may reuse the memory
  another graph's intermediates used. A pool is freed with the last
  graph that shares it, so a capture after every graph was released
  takes a new pool.
- Release: graphs are grouped by slot, the plan-layout keys of the batch
  (ops/plan_cache.py). A key that differs from the slot's graphs in more
  than n_real (and the rows' tail that follows it) replaces them, so a
  layout grow releases the old layout's graph and the graphs are
  bounded by the layout keys, as the JAX package's programs are. Graphs
  that differ only in n_real live side by side, as JAX's programs do:
  batches of other sizes, and the split path's piece count (rounded up
  to 256 by the engines). `clear()` drops every graph; the engines call
  it on every mutation.
- Launch counters: the kernel wrappers count a launch when they are
  called, and under capture nothing is launched. Each graph keeps the
  counts its capture added and sets them back; every replay adds them.
  So the counters count the launches that really ran: the warm-up's and
  each replay's.
- No fallback: a capture that fails (a step that synchronises, reads a
  tensor on the host or copies from pageable memory) raises, with no
  eager retry. On the CPU the engines keep no StepGraphs and run the
  step eagerly; the tests drive StepGraphs there with an injected
  capturer in place of the CUDA graph.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..utils import prof


class StepKey(NamedTuple):
    plan: tuple
    k: int
    scale: float
    clip: float
    mode: str
    n_real: int
    split_p: int
    inputs: tuple  # ((shape, dtype), ...) of the batch's inputs
    resident: tuple  # ((address, shape), ...) and ints the step reads
    merge: bool = False  # the step merges the segments' lists


def step_key(plan, k, scale, clip, mode, n_real, split_p, inputs,
             resident=(), merge=False) -> StepKey:
    """The graph key of one batch (module docstring); `inputs` are its
    host arrays, `resident` from resident_key."""
    return StepKey(plan, k, scale, clip, mode, n_real, split_p,
                   tuple((a.shape, a.dtype.str) for a in inputs),
                   tuple(resident), merge)


def resident_key(tensors, ints=()) -> tuple:
    """The resident part of a key: each tensor's address and shape, then
    the ints (doc bases, local doc counts)."""
    return tuple((t.data_ptr(), tuple(t.shape)) for t in tensors) + tuple(
        int(i) for i in ints)


def run_step(graphs, slot, key: StepKey, step, inputs) -> torch.Tensor:
    """An engine's batch step on its host inputs: the key's graph when
    the engine keeps graphs (the card), else the eager step on CPU
    tensors."""
    if graphs is not None:
        return graphs.run(slot, key, step, inputs)
    return step(*(torch.from_numpy(a) for a in inputs))


def dispatch_span(graphs, name):
    """A serving-path phase timer (utils/prof.py) when the engine keeps
    graphs; none on the CPU, whose search records only the reference's
    phases."""
    return prof.phase(name) if graphs is not None else nullcontext()


def _counters():
    from ..ops.fused import fused_search
    from ..ops.rank import rank_kernel
    from ..ops.segment_merge import segment_merge

    return ((fused_search, "launches"), (fused_search, "launches_large_k"),
            (fused_search, "launches_dlim"), (fused_search, "launches_dv"),
            (rank_kernel, "launches"), (fused_search, "launches_tiled"),
            (segment_merge, "launches"))


def launch_counts() -> tuple:
    """The step's kernel launch counters, in _counters' order."""
    return tuple(getattr(obj, name) for obj, name in _counters())


def add_launch_counts(delta) -> None:
    for (obj, name), d in zip(_counters(), delta):
        setattr(obj, name, getattr(obj, name) + d)


def cuda_capture(pool):
    """The capturer of the card: step(*static_in) captured on the
    current stream into a CUDA graph in `pool`. Returns (replay, static
    output). A step that fails under capture raises.

    Before the capture it waits for the card and frees what the caching
    allocator holds unused, as `torch.cuda.graph` does on entering: the
    allocator cannot release cached blocks while a capture is under way,
    and the capture's pool cannot take blocks cached in the default pool
    (the warm-up's) or in the pools of released graphs, so without this
    a capture can run out of memory on a card whose memory sits cached
    and idle. Unlike `torch.cuda.graph` it runs no gc.collect(): the
    engines free their tensors by reference counting (no cycle holds
    them), so a collection would only add to every capture's time."""

    def capture(step, static_in):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=pool)
        try:
            out = step(*static_in)
        finally:
            graph.capture_end()
        return graph.replay, out

    return capture


def pool_bytes(pool, device) -> int:
    """Device bytes a memory pool of the caching allocator holds: the
    size of its segments (what it took from the card, free blocks in),
    from the allocator's snapshot."""
    pool = tuple(pool)
    return sum(
        seg["total_size"]
        for seg in torch.cuda.memory._snapshot(device)["segments"]
        if tuple(seg["segment_pool_id"]) == pool
    )


class _Graph(NamedTuple):
    replay: object  # () -> None: rewrites static_out from static_in
    static_in: tuple
    static_out: torch.Tensor
    counts: tuple  # the launches one replay makes, in _counters' order


class StepGraphs:
    """One engine's graphs (module docstring). `capturer(step,
    static_in) -> (replay, static_out)` stands in for the CUDA graph
    (cuda_capture, the default on the card)."""

    def __init__(self, device, capturer=None):
        self.device = torch.device(device)
        self._capturer = capturer
        self._pool = None
        self._side = None  # the warm-up and capture stream
        self._stream = None  # the stream of the last run
        self._slots: dict = {}  # slot -> {StepKey: _Graph}
        self._last = None  # (graph, staged inputs) of the last run
        self.captures = 0
        self.replays = 0
        self.capture_ms: list = []  # host ms of each capture, warm-up in

    def __len__(self) -> int:
        return sum(len(g) for g in self._slots.values())

    def fresh(self) -> "StepGraphs":
        """A new StepGraphs on the same device with the same capturer and
        no graph (a pool of its own), for a caller that alternates
        workloads whose keys share a slot (tools/nq_ab.py)."""
        return StepGraphs(self.device, self._capturer)

    def clear(self) -> None:
        """Release every graph (and the last run's inputs)."""
        self._slots.clear()
        self._last = None

    def pool_bytes(self) -> int:
        """Device bytes held by the engine's graph pool (pool_bytes)."""
        return 0 if self._pool is None else pool_bytes(self._pool,
                                                       self.device)

    def run(self, slot, key: StepKey, step, inputs) -> torch.Tensor:
        """The batch's output, a fresh tensor: step(*device inputs)
        through the key's graph, captured first if the key is new.
        `inputs` are the batch's host arrays."""
        staged = [self._stage(a) for a in inputs]
        graphs = self._slots.setdefault(slot, {})
        ent = graphs.get(key)
        if ent is not None:
            return self._replay(ent, staged)
        # the layout grew, or the index changed: only the gather size
        # (and with it the rows' tail) may differ between a slot's graphs
        base = key._replace(n_real=0, inputs=())
        if any(k._replace(n_real=0, inputs=()) != base for k in graphs):
            graphs.clear()
        return self._capture(graphs, key, step, staged)

    def replayer(self):
        """A zero-argument callable that replays the last run's graph on
        the last run's inputs (with its copy-out) and returns a fresh
        output."""
        ent, staged = self._last
        return partial(self._replay, ent, staged)

    # ------------------------------------------------------------------
    def _stage(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        # the caching host allocator keeps a pinned block until the copy
        # recorded on it has run, so a block is never refilled early
        return t.pin_memory() if self.device.type == "cuda" else t

    def _current_stream(self):
        if self.device.type != "cuda":
            return None
        cur = torch.cuda.current_stream(self.device)
        if self._stream is not None and self._stream != cur:
            cur.wait_stream(self._stream)
        self._stream = cur
        return cur

    def _on_side(self, fn):
        """fn() on the side stream, ordered after the current stream's
        work and before its later work."""
        if self.device.type != "cuda":
            return fn()
        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            out = fn()
        cur.wait_stream(self._side)
        return out

    def _capture_fn(self):
        if self._capturer is not None:
            return self._capturer
        if self._pool is None or not len(self):
            from ..ops.fused import _lib

            _lib()  # builds the kernel library if it is not built
            # a pool dies with the last graph that shares it, so a
            # capture after a release of every graph takes a new one
            self._pool = torch.cuda.graph_pool_handle()
        return cuda_capture(self._pool)

    def _capture(self, graphs, key, step, staged) -> torch.Tensor:
        t0 = time.perf_counter()
        capture = self._capture_fn()
        cur = self._current_stream()
        static_in = tuple(torch.empty(s.shape, dtype=s.dtype,
                                      device=self.device) for s in staged)
        for dst, src in zip(static_in, staged):
            dst.copy_(src, non_blocking=True)
        out = self._on_side(lambda: step(*static_in))  # the warm-up
        if cur is not None:
            out.record_stream(cur)
        before = launch_counts()
        replay, static_out = self._on_side(lambda: capture(step, static_in))
        counts = tuple(a - b for a, b in zip(launch_counts(), before))
        add_launch_counts(tuple(-c for c in counts))  # nothing ran
        ent = _Graph(replay, static_in, static_out, counts)
        graphs[key] = ent
        self._last = (ent, staged)
        self.captures += 1
        self.capture_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def _replay(self, ent: _Graph, staged) -> torch.Tensor:
        self._current_stream()
        for dst, src in zip(ent.static_in, staged):
            dst.copy_(src, non_blocking=True)
        ent.replay()
        out = ent.static_out.clone()
        add_launch_counts(ent.counts)
        self.replays += 1
        self._last = (ent, staged)
        return out
