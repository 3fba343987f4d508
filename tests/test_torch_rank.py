"""The rank-only kernel's wrappers (ops/rank.py, what runs on CPU
tensors is their plain version packed.rank_candidates) against the
reference's Pallas rank kernel in interpret mode, on block-sorted rows of
the kind tests/test_rank_pallas.py builds; the xla_rank pack + rank
(pack_tables, then rank_candidates_kernel) against the reference's
search_packed_tables(use_rank_pallas=True); and
the port's engine in the "xla_rank" and "xla" modes against the oracle
and the JAX engine. Exact equality throughout."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.corpus.synth import synth_corpus, synth_queries
from document_search_engine_tpu.engine.engine import SearchEngine as RefEngine
from document_search_engine_tpu.ops import fused_pallas as ref_fused
from document_search_engine_tpu.ops.packed import (
    search_packed_tables as ref_tables,
)
from document_search_engine_tpu.ops.rank_pallas import rank_candidates_pallas
from document_search_engine_tpu.oracle import OracleEngine
from document_search_engine_tpu_torch import SearchEngine
from document_search_engine_tpu_torch import config as port_config
from document_search_engine_tpu_torch.ops import rank as port_rank
from document_search_engine_tpu_torch.ops.packed import pack_tables
from test_packed import make_aligned
from test_rank_pallas import make_block_sorted_rows
from test_torch_merge_model import chip_smoke

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

SCALE = float(np.float32(2.0**16))
CLIP = float(np.float32(65075262.0))


@pytest.mark.parametrize(
    "n_blocks,block,s,n_docs",
    [(4, 256, 4, 500), (8, 256, 8, 120), (2, 512, 2, 3000), (1, 256, 3, 50)],
)
def test_rank_candidates_kernel_matches_rank_pallas(n_blocks, block, s,
                                                    n_docs):
    rng = np.random.default_rng(17 + n_blocks * block + s)
    d, ci = make_block_sorted_rows(rng, nq=6, n_blocks=n_blocks,
                                   block=block, n_docs=n_docs, s=s)
    d[0], ci[0] = n_docs, 0  # an empty query
    for k in (1, 10, 64):
        want = rank_candidates_pallas(
            jnp.asarray(d), jnp.asarray(ci), jnp.int32(7), block=block, s=s,
            k=k, n_docs=n_docs, interpret=True,
        )
        launches = port_rank.rank_kernel.launches
        got = port_rank.rank_candidates_kernel(
            torch.from_numpy(d), torch.from_numpy(ci), 7, block=block, s=s,
            k=k, n_docs=n_docs,
        )
        assert port_rank.rank_kernel.launches == launches  # CPU: plain
        assert got[0].dtype == torch.int32 and got[0].shape == (6, k)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert (got[0][0] == -1).all()


def test_merge_rows_match_rank_pallas():
    """The rows chip_smoke.py aims at the merge on the card (one run, a
    break at every run, unequal runs, sentinel runs in between, equal
    docs in 8 runs, exactly k candidates, crowded winners), at C = 2,048:
    the plain version equals the reference's kernel on them, so the card
    is held against the reference's answers."""
    c, run, n_docs = 2048, 256, 8192
    names, d, ci, s = chip_smoke.merge_rank_rows(
        np.random.default_rng(11), c, run, n_docs)
    for k in (16, 64):
        want = rank_candidates_pallas(
            jnp.asarray(d), jnp.asarray(ci), jnp.int32(0), block=run, s=s,
            k=k, n_docs=n_docs, interpret=True,
        )
        got = port_rank.rank_candidates_kernel(
            torch.from_numpy(d), torch.from_numpy(ci), 0, block=run, s=s,
            k=k, n_docs=n_docs,
        )
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    hits = (got[0] > 0).sum(1).tolist()
    for kk in chip_smoke.MERGE_KS:
        row = names.index(f"exactly {kk} candidates")
        assert hits[row] == min(kk, 64)
    assert hits[names.index("five candidates")] <= 5


def test_rank_kernel_contract():
    """The reference's asserts: C and block powers of two, block >= 128,
    k and s at most 128."""
    z = torch.zeros((2, 4, 128), dtype=torch.int32)
    for kw in (
        dict(block=384, s=2, k=10),  # block not a power of two
        dict(block=64, s=2, k=10),  # block below a row
        dict(block=256, s=2, k=129),
        dict(block=256, s=129, k=10),
    ):
        with pytest.raises(AssertionError):
            port_rank.rank_kernel(z, z, n_docs=5, **kw)
    z3 = torch.zeros((2, 3, 128), dtype=torch.int32)  # C = 384
    with pytest.raises(AssertionError):
        port_rank.rank_kernel(z3, z3, block=128, s=2, k=10, n_docs=5)


@pytest.mark.parametrize("k", [10, 100])
def test_xla_rank_tables_match_reference(k):
    """pack_tables then rank_candidates_kernel, the xla_rank bucket step,
    against the reference's search_packed_tables(use_rank_pallas=True)."""
    rng = np.random.default_rng(5 + k)
    n_terms, n_docs, nq, s, block = 12, 2000, 4, 4, 256
    lens = rng.integers(1, 300, n_terms)
    indptr = np.zeros(n_terms + 1, np.int32)
    np.cumsum(lens, out=indptr[1:])
    post_doc = np.concatenate([
        np.sort(rng.choice(n_docs, size=l, replace=False)).astype(np.int32)
        for l in lens
    ])
    post_val = rng.random(len(post_doc), dtype=np.float32) * 0.9 + 0.05
    d2, v2, row_start = make_aligned(indptr, post_doc, post_val, n_docs)
    rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
    rows[:, -1] = rows[:, 0]  # equal docs from two slots
    coeff = (rng.random((nq, s)) * 1.5 + 0.05).astype(np.float32)
    coeff[1] = 0.0
    lens_q = np.where(coeff > 0, indptr[rows + 1] - indptr[rows], 0)
    nb = 1 << int(np.ceil(np.log2(int((-(-lens_q // block)).sum(1).max()))))
    sr, rm, ab, _dst = ref_fused.plan_tables(row_start, indptr, rows, coeff,
                                             nb, block)
    want = ref_tables(
        jnp.asarray(d2), jnp.asarray(v2), jnp.asarray(sr), jnp.asarray(rm),
        jnp.asarray(ab), jnp.float32(SCALE), jnp.float32(CLIP),
        jnp.int32(300), n_blocks=nb, block=block, s=s, k=k, n_docs=n_docs,
        use_rank_pallas=True, rank_interpret=True,
    )
    t = torch.from_numpy
    d_key, ci = pack_tables(t(d2), t(v2), t(sr), t(rm), t(ab), SCALE, CLIP,
                            nb, block, n_docs)
    got = port_rank.rank_candidates_kernel(d_key, ci, 300, block=block, s=s,
                                           k=k, n_docs=n_docs)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("scorer", ["xla_rank", "xla"])
@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_engine_xla_modes_match_oracle_and_reference(kind, scorer):
    """Two segments, k up to 200 (the rank kernel serves k <= 128, the
    plain rank above), search and search_stream."""
    docs = synth_corpus(n_docs=160, vocab_size=600, mean_len=30, seed=21)
    queries = synth_queries(docs, n_queries=14, terms_per_query=5, seed=22)
    queries += ["", "zzznotaword", docs[0].split()[0]]
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    eng = SearchEngine(port_config.IndexConfig.from_json(cfg.to_json()),
                       device="cpu")
    eng.scorer = scorer
    ora, ref = OracleEngine(cfg), RefEngine(cfg)
    ref.scorer = scorer  # the reference's own mode (Pallas interpreted)
    for e in (eng, ora, ref):
        e.build(docs[:100])
        e.add_docs(docs[100:])
    for k in (1, 10, 17, 128, 200):
        want = ora.search(queries, k=k)
        got = eng.search(queries, k=k)
        np.testing.assert_array_equal(got[0], want[0], f"k={k}")
        np.testing.assert_array_equal(got[1], want[1], f"k={k}")
        if k == 17:  # the reference at one k (its kernel is interpreted)
            got = ref.search(queries, k=k)
            np.testing.assert_array_equal(got[0], want[0], "reference")
            np.testing.assert_array_equal(got[1], want[1], "reference")
    got = list(eng.search_stream([queries[:6], [], queries[6:]], k=10))
    want = ora.search(queries, k=10)
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got]),
                                  want[0])
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got]),
                                  want[1])
