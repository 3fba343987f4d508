"""IR evaluation metrics: recall@k and MAP (BASELINE.json:2,8).

Conventions: `results` is (nq, k) of global doc ids with -1 padding;
`relevant` is a list of per-query sets (or array-likes) of relevant ids.

The torch port's own copy of `document_search_engine_tpu/eval/metrics.py`,
kept identical in behaviour (tests/test_torch_isolation.py holds the
two against each other); the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import numpy as np


def recall_at_k(results: np.ndarray, relevant, k: int | None = None) -> float:
    """Mean over queries of |top-k ∩ relevant| / |relevant|."""
    k = k or results.shape[1]
    vals = []
    for r, rel in zip(results, relevant):
        rel = set(int(x) for x in rel)
        if not rel:
            continue
        got = set(int(x) for x in r[:k] if x >= 0)
        vals.append(len(got & rel) / len(rel))
    return float(np.mean(vals)) if vals else 0.0


def average_precision(ranked: np.ndarray, rel: set) -> float:
    if not rel:
        return 0.0
    hits, s = 0, 0.0
    for i, doc in enumerate(ranked):
        if doc >= 0 and int(doc) in rel:
            hits += 1
            s += hits / (i + 1)
    return s / len(rel)


def mean_average_precision(results: np.ndarray, relevant) -> float:
    vals = [
        average_precision(r, set(int(x) for x in rel))
        for r, rel in zip(results, relevant)
        if len(rel)
    ]
    return float(np.mean(vals)) if vals else 0.0


def ranking_agreement(a_ids: np.ndarray, b_ids: np.ndarray) -> float:
    """Fraction of rows with exactly equal ranked id lists (parity meter)."""
    return float(np.mean(np.all(a_ids == b_ids, axis=1)))
