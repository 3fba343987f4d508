"""Reading a profiler trace of the measured window.

The program's `utils/prof.py trace` writes a Chrome trace; this module
reads it back: the window is the host span the harness names WINDOW, the
device's operations are the events of category kernel, gpu_memcpy and
gpu_memset, clipped to the window.
"""
from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NAME_CHARS = 120
# idle gaps labelled one by one, longest first; the rest are summed
LABELLED_GAPS = 2048
# the label of a gap under which the host runs no traced op: numpy and
# Python work (analysis, planning, collect) or waiting
HOST_OUTSIDE_TORCH = "host outside torch ops"


def merged(intervals):
    """Union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(path: str) -> dict | None:
    """The window's device account from a trace file, in seconds: window,
    busy (union of device operations), kernel (sum of kernel events), the
    device operations by name and the idle gaps by the innermost host
    event under the middle of each (the LABELLED_GAPS longest); None if
    the trace holds no window."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        if t <= w0 or s >= w1:
            continue
        s, t = max(s, w0), min(t, w1)
        if e.get("cat") in DEVICE_CATS:
            dev.append((e["cat"], e["name"], s, t))
        elif e.get("cat") in HOST_CATS and e.get("name") != WINDOW:
            host.append((t - s, s, t, e["name"]))
    busy = merged([(s, t) for _c, _n, s, t in dev])
    by_name = defaultdict(float)
    for _c, name, s, t in dev:
        by_name[name[:NAME_CHARS]] += (t - s) * 1e-6
    host.sort()
    hd = np.array([h[1] for h in host], float)
    he = np.array([h[2] for h in host], float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    spans = sorted(((t - s, s) for s, t in zip(edges[::2], edges[1::2])
                    if t > s), reverse=True)
    gaps = defaultdict(float)
    for i, (g, s) in enumerate(spans):
        label = "shorter gaps"
        if i < LABELLED_GAPS:
            mid = s + g / 2
            hit = np.nonzero((hd <= mid) & (he > mid))[0]
            label = host[hit[0]][3] if hit.size else HOST_OUTSIDE_TORCH
        gaps[label[:NAME_CHARS]] += g * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernel_s": sum(t - s for c, _n, s, t in dev if c == "kernel")
        * 1e-6,
        "kernel_events": sum(1 for c, *_r in dev if c == "kernel"),
        "device_ops": [[n, v] for n, v in top],
        "idle_gaps": [[n, v] for n, v in idle],
    }
