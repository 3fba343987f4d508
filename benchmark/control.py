"""The control of the correctness check: the plain reference put in the
program's place, in the nearest precision below the configuration's.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3

For each seed it draws the cell's corpus and pool as a run does, and the
live documents as the configuration's set-up would leave them
(setups/<name>.py `alive`), ranks the sampled queries with the reference
over those documents in bfloat16 (the configuration states float32
values and contributions) as the program's answers, and judges them with
run.py's comparison against the float32 reference. It prints
one JSON line a seed with the numbers compared; a sound run of the program
reads wrong_answers 0, and the check is only worth its name if the
control reads more.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .run import compare, log

CONTROL_PRECISION = "bfloat16"


def control_reading(reg, name: str, seed: int, device) -> dict:
    """The numbers compared when the bfloat16 reference answers each
    sampled query once."""
    from .gen.corpus import draw_corpus
    from .gen.queries import Pool
    from .registry import setup_of

    wl = reg.workload(name)
    cfg = reg.config(wl["config"])
    Reference = reg.reference(cfg["scoring"]["kind"])
    traffic = reg.traffic(wl["traffic"])
    k = int(traffic["k"])
    corpus = draw_corpus(cfg, seed, device, texts=False)
    pool = Pool(cfg, traffic, corpus, seed)
    alive = reg.alive(setup_of(cfg)["name"])(cfg, corpus.n_docs, seed)
    ref = Reference(corpus, cfg["scoring"], cfg["max_query_terms"], device,
                    alive=alive)
    texts = [pool.text(q) for q in pool.sample]
    ids, scores = ref.topk(texts, k)
    c_ids, c_scores = ref.topk(texts, k, precision=CONTROL_PRECISION)
    answers = {int(q): [(c_ids[i], c_scores[i])]
               for i, q in enumerate(pool.sample)}
    return compare(answers, pool.sample, ids, scores)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)

    import torch

    from .registry import Registry

    if not torch.cuda.is_available():
        log("the control runs on the card")
        return 2
    reg = Registry()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        checks = control_reading(reg, args.workload, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": CONTROL_PRECISION,
                          "seconds": time.time() - t, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
