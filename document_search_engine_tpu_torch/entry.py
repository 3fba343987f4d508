"""Entry points: the single-card packed step and the sharded dry run.

Port of the repo-root `__graft_entry__.py`, which stays the JAX
package's:

entry(device=None)       (fn, example_args): the packed search step of a
                         toy bm25 engine — the slice-packed scorer
                         (ops/packed.py pack_ds at block 512, n_blocks
                         from ops/schedule.py block_plan) ranked by the
                         rank-only kernel (ops/rank.py
                         rank_candidates_kernel), the counterpart of the
                         reference's search_packed_ds(use_rank_pallas=True);
                         fn(*example_args) is (vals, gids) (8, 10) int32.
dryrun_multichip(n)      the device CSR pack, then the sharded engine's
                         build and search over an n-shard mesh, tfidf and
                         bm25, each ranking asserted equal, ids and
                         integer scores, to the oracle's; then the same
                         with doc-range splitting.

Both run on the card unless given device="cpu"; without CUDA the card
raises. On CPU tensors the rank-only kernel's wrapper takes its plain
version.

    python -m document_search_engine_tpu_torch.entry   # both, on the card
"""
from __future__ import annotations

import numpy as np
import torch

from .config import IndexConfig, ScoringConfig
from .corpus.synth import synth_corpus, synth_queries
from .engine.engine import SearchEngine
from .engine.query import segment_rows
from .ops.packed import pack_ds
from .ops.rank import rank_candidates_kernel
from .ops.schedule import block_plan
from .oracle import OracleEngine, spec

F32 = np.float32
BLOCK = 512


def _toy_engine(device):
    """The reference entry's toy bm25 engine (64 docs) and its 8 queries."""
    docs = synth_corpus(n_docs=64, vocab_size=300, mean_len=24, seed=5)
    queries = synth_queries(docs, n_queries=8, terms_per_query=4, seed=6)
    eng = SearchEngine(IndexConfig(scoring=ScoringConfig(kind="bm25")),
                       device=device)
    eng.build(docs)
    return eng, queries


def entry(device=None):
    """(fn, example_args): the single-card forward search step of a toy
    engine, the packed step with the rank-only kernel, k = 10."""
    eng, queries = _toy_engine(device)
    host, seg = eng.segments[0]
    slot_h, coeff = eng.frontend.analyze(queries, eng.stats)
    rows, found = segment_rows(host.term_hash, slot_h)
    coeff = np.where(found, coeff, F32(0.0)).astype(F32)
    nb = block_plan(host.indptr, rows, found, block=BLOCK)
    k, n_docs, s = 10, host.n_docs, rows.shape[1]

    def forward(post_doc, post_val, indptr, row_start, rows, coeff, scale,
                clip):
        d_key, ci = pack_ds(
            post_doc, post_val, indptr, row_start, rows, coeff, scale, clip,
            n_blocks=nb, n_docs=n_docs, block=BLOCK,
        )
        return rank_candidates_kernel(
            d_key, ci, 0, block=BLOCK, s=s, k=k, n_docs=n_docs
        )

    dev = eng.device
    example_args = (
        seg.post_doc,
        seg.post_val,
        seg.indptr,
        seg.row_start,
        torch.from_numpy(rows).to(dev),
        torch.from_numpy(coeff).to(dev),
        float(F32(2.0**eng.config.scoring.scale_bits)),
        float(F32(int(spec.quant_clip_max(eng.config.max_query_terms)))),
    )
    return forward, example_args


def dryrun_multichip(n_shards: int, device=None) -> None:
    """The sharded pipeline on an n_shards mesh at toy size: the device
    CSR pack (builder.device_pack) against the host pack, then for tfidf
    and bm25 the sharded build and one search (k = 5), whose ids and
    integer scores must equal the oracle's, and the same search with
    doc-range splitting (split_rows = 2). Raises AssertionError on any
    difference."""
    from .index.builder import device_pack, host_pack
    from .parallel.dist import DistributedSearchEngine
    from .parallel.mesh import make_mesh

    mesh = make_mesh(n_shards, device)
    docs = synth_corpus(
        n_docs=8 * n_shards, vocab_size=200, mean_len=16, seed=21
    )
    queries = synth_queries(docs, n_queries=4, terms_per_query=3, seed=22)

    # the device CSR pack, against its host twin
    triples = [np.array(x, np.int32) for x in
               ([2, 0, 1, 0, 2], [1, 0, 1, 2, 0], [1, 2, 1, 3, 1])]
    got = device_pack(*(torch.from_numpy(x).to(mesh.dst) for x in triples),
                      n_terms=3, n_docs=3)
    r, d, t, indptr = host_pack(*triples, n_terms=3, n_docs=3)
    for g, w in zip(got[:4], (r, d, t, indptr)):
        assert np.array_equal(g.cpu().numpy(), w), (g, w)
    assert got[4].cpu().tolist() == [2, 1, 2], got[4]  # df
    assert got[5].cpu().tolist() == [3, 2, 3], got[5]  # dl

    # sharded end to end: build + one search, ranked as the oracle ranks
    for kind in ("tfidf", "bm25"):
        cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
        eng = DistributedSearchEngine(cfg, mesh=mesh)
        eng.build(docs)
        ids, scores = eng.search(queries, k=5)
        ora = OracleEngine(cfg)
        ora.build(docs)
        o_ids, o_scores = ora.search(queries, k=5)
        assert np.array_equal(ids, o_ids) and np.array_equal(
            scores, o_scores), (kind, ids, o_ids, scores, o_scores)
        assert (scores[:, 0] > 0).all(), (kind, scores)
    # doc-range splitting over the mesh (per-shard quantile tables and
    # doc limits) must give the same ranking
    eng.scorer = "fused"
    eng.split_rows = 2
    s_ids, s_scores = eng.search(queries, k=5)
    assert np.array_equal(s_ids, o_ids) and np.array_equal(
        s_scores, o_scores), (s_ids, o_ids, s_scores, o_scores)
    print(
        f"dryrun_multichip OK: {n_shards} shards on {mesh}, tfidf+bm25 "
        f"sharded search == the oracle (+ split_rows piece path)"
    )


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry OK:", [tuple(o.shape) for o in out])
    dryrun_multichip(max(torch.cuda.device_count(), 1))
