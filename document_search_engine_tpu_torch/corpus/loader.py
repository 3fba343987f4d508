"""Corpus ingestion (SURVEY.md §1 L1): stream plain-text files.

The reference's canonical run is "~1k plain-text files" (BASELINE.json:7):
`load_dir` walks a directory tree, yielding (name, text) sorted by path for
deterministic doc ids. `stream_batches` chunks any doc iterable for the
streaming build (BASELINE.json:10).

The torch port's own copy of `document_search_engine_tpu/corpus/loader.py`,
kept identical in behaviour (tests/test_torch_isolation.py holds the
two against each other); the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import os
from typing import Iterable, Iterator


def load_dir(path: str, suffixes=(".txt", ".text", "")) -> list:
    """[(relative_name, text)] for files under `path`, path-sorted."""
    out = []
    for root, _dirs, files in os.walk(path):
        for fname in files:
            if suffixes and not any(
                fname.endswith(s) for s in suffixes if s
            ):
                if "" not in suffixes or "." in fname.rsplit("/", 1)[-1][1:]:
                    continue
            full = os.path.join(root, fname)
            rel = os.path.relpath(full, path)
            try:
                with open(full, "r", encoding="utf-8", errors="replace") as f:
                    out.append((rel, f.read()))
            except OSError:
                continue
    out.sort(key=lambda t: t[0])
    return out


def stream_batches(docs: Iterable, batch_size: int = 4096) -> Iterator[list]:
    """Chunk an iterable of docs into build batches."""
    batch = []
    for d in docs:
        batch.append(d)
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch
