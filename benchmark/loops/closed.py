"""The closed loop: batch clients that wait for their results.

`search_stream` pulls the next batch as soon as its window of `depth`
batches in flight has room, so the offered load is whatever the program
takes; nothing is paced by a clock.
"""
from __future__ import annotations

import time


def serve(eng, pool, traffic: dict, order, deadline=None, keep=None,
          max_batches=None):
    """search_stream over the pool's batches in `order`, round and round
    until `deadline` (perf_counter) when given, else once, and at most
    `max_batches` batches when given. Returns the (batch, pull time) of
    each batch, each batch's latency from its pull to its results, and
    the time the last results came."""
    pulls = []

    def source():
        i = 0
        while deadline is not None or i < len(order):
            if deadline is not None and time.perf_counter() >= deadline:
                return
            if max_batches is not None and i >= max_batches:
                return
            j = int(order[i % len(order)])
            pulls.append((j, time.perf_counter()))
            yield pool.batches[j]
            i += 1

    lat = []
    for n, (ids, scores) in enumerate(eng.search_stream(
            source(), k=int(traffic["k"]), depth=int(traffic["depth"]))):
        now = time.perf_counter()
        j, t_pull = pulls[n]
        lat.append(now - t_pull)
        if keep is not None:
            keep(j, ids, scores)
    return pulls, lat, time.perf_counter()
