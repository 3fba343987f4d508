"""The port's counterparts of the repo-root tools that drive the JAX
package, each written against the port's public API and run with
`python -m document_search_engine_tpu_torch.tools.<name>`:

- `fuzz_differential`: the engines against the oracle on random trials
  (kind x k x scorer x split x shards x an add/delete/compact history).
- `segments_bench`: serving at 1, 2, 4, 8 and 16 streaming segments of
  one corpus.
- `host_profile`: the host's analyze -> _dispatch -> _collect of a bench
  batch with the device step replaced by a shaped dummy, and a cProfile
  of the dispatch.
- `step_ab`: one bench batch's device step timed under each lever
  setting (block family, dv planes, split rows, min blocks, the fused
  kernel's thread rule and compaction granule), bit-identical to the
  baseline.
- `nq_ab`: the public serving loop at several batch sizes, legs
  interleaved, each on its own plan layouts and step graphs.
- `roofline`: the fused kernel's stages (plan table, load, natural
  runs, merge, run-sums, select, output) against the card's peaks on the
  bench's reconstructed batch, timed bucket by bucket on the card.

Each runs on the card unless the CPU is asked for (`--device cpu`, or
`main(device="cpu")`); asking for the card without CUDA raises.
"""
from __future__ import annotations

import argparse


def device_arg(prog: str) -> str:
    """The `--device` of a tool's command line (default: the card)."""
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                    "kernels' plain versions)")
    return ap.parse_args().device
