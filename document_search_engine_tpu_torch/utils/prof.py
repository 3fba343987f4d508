"""Phase timers, structured metrics and the device trace.

Port of `document_search_engine_tpu/utils/prof.py`:

- `phase(name)`: a wall-clock phase timer accumulating into one registry
  per process (emit it with `metrics_json()`, clear it with `reset()`).
  The engine records `build.analyze` (SearchEngine.add_docs),
  `search.analyze` and `search.score` (SearchEngine.search).
- `sync(x)`: wait for the device work feeding a tensor.
- `trace(path)`: a `torch.profiler` trace of the block, with the card's
  kernels when CUDA is present, written as a Chrome trace (JSON) that
  Perfetto (ui.perfetto.dev) and chrome://tracing open; its events of
  category "kernel" are the device's kernels, with start and duration
  in microseconds.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import torch

_PHASES: dict = defaultdict(float)
_COUNTS: dict = defaultdict(int)


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
    given) and one count to phase `name`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync_on is not None:
            sync(sync_on)
        _PHASES[name] += time.perf_counter() - t0
        _COUNTS[name] += 1


def metrics_json(**extra) -> str:
    """The registry as one JSON record: {"phases_s", "counts", **extra}."""
    rec = {
        "phases_s": {k: round(v, 4) for k, v in _PHASES.items()},
        "counts": dict(_COUNTS),
    }
    rec.update(extra)
    return json.dumps(rec, sort_keys=True)


def mean_ms(name: str):
    """Mean wall-clock ms a block of phase `name` since reset(); None if
    none ran."""
    n = _COUNTS.get(name)
    return _PHASES[name] * 1e3 / n if n else None


def reset() -> None:
    _PHASES.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def trace(path: str):
    """Profiles the block (CPU activity, and CUDA activity when a card is
    present) and writes the Chrome trace to `path`. Yields the profiler
    (its key_averages() sums time by name)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
