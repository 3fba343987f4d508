"""CLI of the torch port: index build, search, serve, eval.

    python -m document_search_engine_tpu_torch index  <corpus_dir> --out <idx_dir>
    python -m document_search_engine_tpu_torch search <idx_dir> "query text" -k 10
    python -m document_search_engine_tpu_torch serve  <idx_dir>  (queries on stdin)
    python -m document_search_engine_tpu_torch eval   [--kind bm25]

Port of `document_search_engine_tpu/cli.py`, with the same commands,
options and output lines. Every command runs on the card unless given
`--device cpu`. An index saved by either package opens here. Not ported
yet, and refused with NotImplementedError naming its ROADMAP item: the
sharded index (`index --shards N`, and opening a sharded checkpoint;
A13) and `bench` (A6).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch package yet (ROADMAP {item})"
    )


def _open_index(index_dir: str, device):
    """Open a single-engine checkpoint; a sharded one is refused."""
    from .engine.engine import SearchEngine

    with open(f"{index_dir}/meta.json") as f:
        meta = json.load(f)
    if meta.get("sharded"):
        raise _not_ported("a sharded index (DistributedSearchEngine)", "A13")
    return SearchEngine.load(index_dir, device=device)


def cmd_index(args):
    from .config import IndexConfig, ScoringConfig
    from .corpus.loader import load_dir
    from .engine.engine import SearchEngine

    if args.shards:
        raise _not_ported("index --shards (the sharded engine)", "A13")
    docs = load_dir(args.corpus_dir)
    if not docs:
        print(f"no documents found under {args.corpus_dir}", file=sys.stderr)
        return 1
    names = [n for n, _ in docs]
    cfg = IndexConfig(scoring=ScoringConfig(kind=args.kind))
    eng = SearchEngine(cfg, device=args.device)
    t0 = time.perf_counter()
    eng.build([t for _, t in docs])
    dt = time.perf_counter() - t0
    eng.save(args.out)
    with open(f"{args.out}/docnames.json", "w") as f:
        json.dump(names, f)
    print(
        json.dumps(
            {
                "docs": len(docs),
                "terms": int(len(eng.stats.vocab)),
                "build_secs": round(dt, 2),
                "docs_per_sec": round(len(docs) / dt, 1),
                "out": args.out,
            }
        )
    )
    return 0


def cmd_search(args):
    eng = _open_index(args.index_dir, args.device)
    try:
        with open(f"{args.index_dir}/docnames.json") as f:
            names = json.load(f)
    except OSError:
        names = None
    t0 = time.perf_counter()
    if args.rerank:
        ids, rerank_scores, scores = eng.search_rerank(
            [args.query], k=args.k
        )
    else:
        ids, scores = eng.search([args.query], k=args.k)
        rerank_scores = None
    dt = time.perf_counter() - t0
    sb = eng.config.scoring.scale_bits
    for rank, (g, s) in enumerate(zip(ids[0], scores[0]), 1):
        if g < 0:
            break
        name = names[g] if names and g < len(names) else str(g)
        extra = (
            f"  rerank={rerank_scores[0][rank - 1] / (1 << 20):.4f}"
            if rerank_scores is not None
            else ""
        )
        print(
            f"{rank:3d}. {name}  score={s / (1 << sb):.6f}{extra}"
            f"  (doc {g})"
        )
    print(f"[{dt*1e3:.1f} ms]", file=sys.stderr)
    return 0


def cmd_serve(args):
    """Pipelined stdin serving loop: one query per line, batched into
    `--batch`-sized groups, dispatched through the depth-pipelined
    search_stream; one JSON result line per query on stdout."""
    eng = _open_index(args.index_dir, args.device)

    def batches():
        buf = []
        for line in sys.stdin:
            q = line.strip()
            if not q:
                continue
            buf.append(q)
            if len(buf) >= args.batch:
                yield buf
                buf = []
        if buf:
            yield buf

    sb = eng.config.scoring.scale_bits
    n = 0
    t0 = time.perf_counter()
    for ids, scores in eng.search_stream(batches(), k=args.k):
        for row_ids, row_scores in zip(ids, scores):
            hits = [
                {"doc": int(g), "score": float(s) / (1 << sb)}
                for g, s in zip(row_ids, row_scores)
                if g >= 0
            ]
            print(json.dumps({"hits": hits}), flush=True)
            n += 1
    dt = time.perf_counter() - t0
    if n:
        print(
            f"[{n} queries in {dt:.3f}s -> {n/dt:,.0f} q/s]",
            file=sys.stderr,
        )
    return 0


def cmd_eval(args):
    from .config import IndexConfig, ScoringConfig
    from .engine.engine import SearchEngine
    from .eval.harness import (
        parity_report,
        topic_corpus,
        topic_queries,
    )
    from .oracle import OracleEngine

    docs, doc_topics, topics = topic_corpus(seed=args.seed)
    queries, q_topics = topic_queries(topics)
    cfg = IndexConfig(scoring=ScoringConfig(kind=args.kind))
    eng = SearchEngine(cfg, device=args.device)
    eng.build(docs)
    ora = OracleEngine(cfg)
    ora.build(docs)
    rep = parity_report(eng, ora, queries, q_topics, doc_topics)
    print(json.dumps(rep, indent=2))
    return 0


def cmd_bench(args):
    # the JAX package's bench runs bench.py, which imports that package
    raise _not_ported("bench (the port's benchmark)", "A6")


def main(argv=None):
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default: the card; 'cpu' runs the "
        "plain PyTorch versions of the kernels)",
    )
    p = argparse.ArgumentParser(prog="document_search_engine_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", parents=[common],
                        help="build an index from a directory")
    pi.add_argument("corpus_dir")
    pi.add_argument("--out", required=True)
    pi.add_argument("--kind", default="bm25", choices=["tfidf", "bm25"])
    pi.add_argument(
        "--shards",
        type=int,
        default=0,
        help="a document-sharded index over N devices (not ported yet; "
        "0 = single engine)",
    )
    pi.set_defaults(fn=cmd_index)

    ps = sub.add_parser("search", parents=[common],
                        help="query a saved index")
    ps.add_argument("index_dir")
    ps.add_argument("query")
    ps.add_argument("-k", type=int, default=10)
    ps.add_argument(
        "--rerank",
        action="store_true",
        help="hybrid dense rerank of the lexical candidates",
    )
    ps.set_defaults(fn=cmd_search)

    pv = sub.add_parser(
        "serve", parents=[common],
        help="pipelined batch serving: queries on stdin",
    )
    pv.add_argument("index_dir")
    pv.add_argument("-k", type=int, default=10)
    pv.add_argument("--batch", type=int, default=256)
    pv.set_defaults(fn=cmd_serve)

    pe = sub.add_parser("eval", parents=[common],
                        help="topic-corpus quality + parity report")
    pe.add_argument("--kind", default="bm25", choices=["tfidf", "bm25"])
    pe.add_argument("--seed", type=int, default=0)
    pe.set_defaults(fn=cmd_eval)

    pb = sub.add_parser("bench", parents=[common],
                        help="the throughput benchmark (not ported yet)")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
