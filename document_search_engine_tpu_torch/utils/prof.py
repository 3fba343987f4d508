"""Phase timers, counters, structured metrics and the device trace.

Port of `document_search_engine_tpu/utils/prof.py`:

- `phase(name, sync_on=None)`: a wall-clock phase timer
  accumulating into one registry per process (emit it with
  `metrics_json()`, read a mean with `mean_ms()`, clear it with
  `reset()`). While a `trace` is open (the module flag `_TRACING`, which
  `trace` sets and clears) the block also runs under
  `torch.profiler.record_function(name)`, so the span lands in the Chrome
  trace as a "user_annotation" event on the device trace's clock and on
  the thread that ran it. Outside a trace a phase costs one perf_counter
  pair and two dict updates under the registry's lock.
- `count(name, n)`: adds n to counter `name`; `total(name)` reads it.
  Counters are cleared by `reset()` and exported by `metrics_json()`
  under "counters" ("counts" is the number of blocks of each phase).
- `sync(x)`: wait for the device work feeding a tensor.
- `trace(path)`: a `torch.profiler` trace of the block, on every thread
  that runs torch or a phase, with the card's kernels when CUDA is
  present, written as a Chrome trace (JSON) that Perfetto
  (ui.perfetto.dev) and chrome://tracing open; its events of category
  "kernel" are the device's kernels, with start and duration in
  microseconds.

This is the one list of what the engines record; engine/engine.py
points here. `build.analyze` (SearchEngine.add_docs), `search.analyze`
and `search.score` (SearchEngine.search; the sharded engine records
neither, as in the reference), as the JAX engine does; and, where an
engine keeps step graphs (on the card; engine/step_graph.py
dispatch_span), the serving path's spans, one of each a batch of a
search_stream (the path both engines share, engine/engine.py
ServingEngine; DistributedSearchEngine's own `_collect` records no
collect.* span):

    stream.analyze         analysis worker  frontend.analyze_rows
    stream.wait_analysis   main             the wait for that analysis
    dispatch.plan          main             _dispatch's host planning
    dispatch.enqueue       main             staging, copies, the replay
    collect.wait           main             out.cpu(): the card, the D2H
    collect.assemble       main             the rest of _collect
    collect.merge_segments main             in collect.assemble, the
                                            host's merge of several
                                            segments' top k (none at one
                                            segment, none where the step
                                            merged them on the device)

and the counters `step.pairs`, the (query, posting) pairs a batch's plan
asks the kernels to score, `step.tiled_pairs`, those of them in the
buckets that the tiled kernels serve (ops/tiled.py tiled_route),
`step.dead_pairs`, those of them whose document is tombstoned,
`step.segment_merge_queries`, the batch's queries where it runs over
several segments (else 0), and `step.device_merge_queries`, the same
where the step merges the segments on the device (else 0); all counted
under SearchEngine's dispatch.plan (the sharded engine counts none).

The registry is shared by threads (search_stream's analysis runs on a
worker while the main thread dispatches), so every update and read of
it holds one lock.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict

import torch

_LOCK = threading.Lock()
_PHASES: dict = defaultdict(float)
_COUNTS: dict = defaultdict(int)
_TOTALS: dict = defaultdict(int)
_TRACING = False  # set by trace() while its profiler runs


def sync(x) -> None:
    """Wait for the device work feeding `x`, a tensor or a tuple/list
    whose first element is one: synchronizes a CUDA tensor's device;
    a CPU tensor has nothing in flight."""
    leaf = x[0] if isinstance(x, (tuple, list)) else x
    if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


@contextlib.contextmanager
def phase(name: str, sync_on=None):
    """Adds the block's wall-clock seconds (after syncing `sync_on`, when
    given) and one count to phase `name`; inside a trace, the block is
    also a record_function span named `name`."""
    span = None
    if _TRACING:
        span = torch.profiler.record_function(name)
        span.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync_on is not None:
            sync(sync_on)
        dt = time.perf_counter() - t0
        if span is not None:
            span.__exit__(None, None, None)
        with _LOCK:
            _PHASES[name] += dt
            _COUNTS[name] += 1


def count(name: str, n: int) -> None:
    """Adds n to counter `name`."""
    with _LOCK:
        _TOTALS[name] += int(n)


def total(name: str):
    """Counter `name`'s sum since reset(); None if nothing was counted."""
    with _LOCK:
        return _TOTALS.get(name)


def metrics_json(**extra) -> str:
    """The registry as one JSON record: {"phases_s", "counts",
    "counters", **extra}."""
    with _LOCK:
        rec = {
            "phases_s": {k: round(v, 4) for k, v in _PHASES.items()},
            "counts": dict(_COUNTS),
            "counters": dict(_TOTALS),
        }
    rec.update(extra)
    return json.dumps(rec, sort_keys=True)


def mean_ms(name: str):
    """Mean wall-clock ms a block of phase `name` since reset(); None if
    none ran."""
    with _LOCK:
        n = _COUNTS.get(name)
        return _PHASES[name] * 1e3 / n if n else None


def reset() -> None:
    with _LOCK:
        _PHASES.clear()
        _COUNTS.clear()
        _TOTALS.clear()


@contextlib.contextmanager
def trace(path: str):
    """Profiles the block (CPU activity on every thread, and CUDA
    activity when a card is present), with every phase a span, and
    writes the Chrome trace to `path`. Yields the profiler (its
    key_averages() sums time by name)."""
    global _TRACING
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # torch records only the thread that opened the profiler unless told
    # to record every thread (search_stream's analysis runs on a worker)
    every_thread = torch.profiler._ExperimentalConfig(
        profile_all_threads=True)
    with torch.profiler.profile(activities=acts,
                                experimental_config=every_thread) as prof:
        _TRACING = True
        try:
            yield prof
            if cuda:
                torch.cuda.synchronize()
        finally:
            _TRACING = False
    prof.export_chrome_trace(path)
