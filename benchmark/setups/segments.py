"""A live index: the drawn documents streamed in as segments, then a share
of them deleted, as a Lucene or Elasticsearch index is served between
merges (each refresh writes a segment, deleted documents stay as
tombstones until a merge drops them).

The configuration's `setup` holds:

- `segments`: the documents split into that many contiguous batches, in
  id order, each a segment of `SearchEngine.build_streaming`, so that
  global ids stay the drawn order;
- `deleted_share`: that share of the documents, drawn uniformly from the
  run's seed, deleted by one `SearchEngine.delete_docs` call;
- `auto_compact_segments`, `auto_compact_dead_frac`: the engine's
  lifecycle policy, set before the build; null turns that check off.
"""
from __future__ import annotations

import sys

import numpy as np

from ..gen.corpus import seed_int

# the deletions' own stream of the seed, apart from the pool's draws
STREAM = 1


def alive(cfg: dict, n_docs: int, seed: int) -> np.ndarray:
    """(n_docs,) bool: False for the documents that `build` deletes."""
    share = float(cfg["setup"]["deleted_share"])
    if not 0.0 <= share < 1.0:
        raise ValueError(f"deleted_share {share} is not in [0, 1)")
    rng = np.random.default_rng([seed_int(seed), STREAM])
    dead = rng.choice(n_docs, size=round(share * n_docs), replace=False)
    mask = np.ones(n_docs, bool)
    mask[dead] = False
    return mask


def build(eng, texts: list, cfg: dict, seed: int) -> np.ndarray:
    """Streams the texts in as segments and deletes `alive`'s dead
    documents; returns the mask."""
    setup = cfg["setup"]
    eng.auto_compact_segments = setup["auto_compact_segments"]
    eng.auto_compact_dead_frac = setup["auto_compact_dead_frac"]
    n, s = len(texts), int(setup["segments"])
    cuts = [i * n // s for i in range(s + 1)]
    eng.build_streaming(texts[a:b] for a, b in zip(cuts, cuts[1:]))
    mask = alive(cfg, n, seed)
    eng.delete_docs(np.flatnonzero(~mask))
    print(f"built: {len(eng.segments)} segments held, "
          f"{n - int(mask.sum())} of {n} docs dead, resident "
          f"{eng.resident_bytes()} B", file=sys.stderr, flush=True)
    return mask
