"""The least time a card could take for a batch's scoring, from its inputs.

Counted from what the batch asks for, never from how the program plans or
runs it, so that a change to the plan cannot move the bound:

- bytes: each input byte once a batch: the postings of the union of the
  batch's distinct terms, 8 B each (a doc id and a value of 4 B), the
  queries (a term row and a coefficient, 4 B each, per distinct term of a
  query) and the outputs (an id and a score, 4 B each, k a query);
- operations: one integer operation a (query, posting) pair.

The least time is the larger of bytes over the card's memory bandwidth
and operations over its int32 rate (SMs x int32 lanes an SM x the SM
clock). Peaks are the data sheet's; the clock is the one nvidia-smi reads
as the card's maximum, the data sheet's where it reads none.
"""
from __future__ import annotations

import subprocess

import numpy as np

# NVIDIA's data sheets (H100 SXM5 80 GB: HBM3 at 3.35 TB/s, 132 SMs, 64
# int32 lanes an SM, boost clock 1,980 MHz).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_s": 3.35e12, "sms": 132, "int32_lanes_sm": 64,
        "sm_clock_mhz": 1980.0,
    },
}
POSTING_BYTES = 8
QUERY_TERM_BYTES = 8
RESULT_BYTES = 8


def card_readings() -> dict:
    """nvidia-smi's name, power limit and maximum SM clock of card 0; {}
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return {}
    name, power, clock = [f.strip() for f in out.split(",")]
    return {"name": name, "power_limit_w": power, "sm_clock_mhz": clock}


def peaks_for(device_name: str, readings: dict) -> dict | None:
    """Bandwidth and int32 rate of the named card; None for a card not in
    the table."""
    p = PEAKS.get(device_name)
    if p is None:
        return None
    try:
        clock = float(readings.get("sm_clock_mhz", ""))
    except ValueError:
        clock = p["sm_clock_mhz"]
    return {
        "hbm_bytes_s": p["hbm_bytes_s"],
        "int32_ops_s": p["sms"] * p["int32_lanes_sm"] * clock * 1e6,
        "sm_clock_mhz": clock,
    }


def batch_counts(terms: list, df: np.ndarray, k: int) -> dict:
    """Bytes and operations of one batch: `terms` holds each query's
    distinct term ids, `df` the corpus's df by term id."""
    distinct = sum(len(t) for t in terms)
    union = np.unique(np.concatenate(terms)) if terms else np.zeros(0, int)
    pairs = int(sum(int(df[t].sum()) for t in terms))
    return {
        "bytes": int(df[union].sum()) * POSTING_BYTES
        + distinct * QUERY_TERM_BYTES + len(terms) * k * RESULT_BYTES,
        "ops": pairs,
    }


def least_seconds(counts: dict, peaks: dict) -> float:
    return max(counts["bytes"] / peaks["hbm_bytes_s"],
               counts["ops"] / peaks["int32_ops_s"])
