"""The fused_dv path: the port's interleaved plane is the reference's bit
for bit; fused_search_dv on CPU tensors (its plain version, the two-plane
search over the plane's halves) equals the reference's dv Pallas kernel
in interpret mode on the same plan tables; and the port's engine in the
"fused_dv" mode equals the oracle and the JAX engine, with the dv-plane
cache following add_docs. Exact equality throughout."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.corpus.synth import synth_corpus, synth_queries
from document_search_engine_tpu.engine.engine import SearchEngine as RefEngine
from document_search_engine_tpu.ops import fused_dv as ref_dv
from document_search_engine_tpu.ops import fused_pallas as ref_fused
from document_search_engine_tpu.oracle import OracleEngine
from document_search_engine_tpu_torch import SearchEngine
from document_search_engine_tpu_torch import config as port_config
from document_search_engine_tpu_torch.ops import fused as port_fused
from document_search_engine_tpu_torch.ops import fused_dv as port_dv
from test_fused_pallas import _csr
from test_packed import make_aligned

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

SCALE = float(np.float32(2.0**16))
CLIP = float(np.float32(65075262.0))


def _planes(seed, n_terms, n_docs, max_len):
    rng = np.random.default_rng(seed)
    indptr, post_doc, post_val, _nnz = _csr(rng, n_terms, n_docs, max_len)
    d2, v2, row_start = make_aligned(indptr, post_doc, post_val, n_docs)
    return rng, indptr, d2, v2, row_start


def test_interleave_planes_matches_reference():
    _rng, _ip, d2, v2, _rs = _planes(3, 20, 2500, 1500)
    want = np.asarray(ref_dv.interleave_planes(jnp.asarray(d2),
                                               jnp.asarray(v2)))
    got = port_dv.interleave_planes(torch.from_numpy(d2),
                                    torch.from_numpy(v2))
    assert got.dtype == torch.int32 and got.shape == (d2.shape[0] + 8, 256)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "seed,block,k,missing",
    [(41, 256, 10, 0.0), (42, 512, 10, 0.0), (7, 1024, 10, 0.4),
     (9, 1024, 17, 0.4), (13, 4096, 10, 0.0)],
)
def test_fused_search_dv_matches_pallas_kernel(seed, block, k, missing):
    """The blocks of tests/test_fused_dv.py, 256 to 4096, over rows of up
    to three blocks (at most 1,500 postings), missing slots, empty
    queries, k 17 through the large-k branch."""
    rng, indptr, d2, v2, row_start = _planes(seed, 24, 5000,
                                             min(1500, 3 * block))
    nq, s = 6, 4
    rows = rng.integers(0, 24, (nq, s)).astype(np.int32)
    coeff = (rng.random((nq, s)) * 1.5).astype(np.float32)
    coeff[rng.random((nq, s)) < missing] = 0.0
    coeff[0] = coeff[5] = 0.0  # empty queries
    lens = np.where(coeff > 0, indptr[rows + 1] - indptr[rows], 0)
    nb = 1 << int(np.ceil(np.log2(max(int((-(-lens // block)).sum(1).max()),
                                      1))))
    sr, rm, ab, dst = ref_fused.plan_tables(row_start, indptr, rows, coeff,
                                            nb, block)
    crows = ref_fused._compact_rows(rm[:, 0, :], block)
    r_c = 1 << int(np.ceil(np.log2(max(int(crows.sum(1).max()), 1))))
    dv_ref = ref_dv.interleave_planes(jnp.asarray(d2), jnp.asarray(v2))
    want = ref_dv.fused_search_dv_pallas(
        dv_ref, jnp.asarray(sr), jnp.asarray(rm), jnp.asarray(ab),
        jnp.asarray(dst), n_blocks=nb, block=block, s=s, k=k, n_docs=5000,
        scale=SCALE, clip=CLIP, r_c=r_c, q_stack=1, interpret=True,
    )
    t = torch.from_numpy
    dv = port_dv.interleave_planes(t(d2), t(v2))
    launches = port_fused.fused_search.launches_dv
    got = port_dv.fused_search_dv(
        dv, t(sr), t(rm), t(ab), t(dst), n_blocks=nb, block=block, s=s, k=k,
        n_docs=5000, scale=SCALE, clip=CLIP, r_c=r_c,
        key_bits=port_fused.key_bits_for(s, 5000),
    )
    assert port_fused.fused_search.launches_dv == launches  # CPU: plain
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[0][0] == -1).all() and (got[0] > 0).any()


@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_engine_fused_dv_matches_oracle_and_reference(kind):
    """scorer="fused_dv" through the whole dispatch, k up to 200 (k > 128
    downgrades to "fused", which the plain scorer serves), against the
    oracle and the JAX engine (its fused_dv mode, interpreted, for bm25;
    its plain scorer for tfidf); add_docs replaces the planes and drops
    the cached dv plane."""
    docs = synth_corpus(n_docs=90, vocab_size=400, mean_len=25, seed=51)
    queries = synth_queries(docs, n_queries=6, seed=52) + ["", "zzz"]
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    eng = SearchEngine(port_config.IndexConfig.from_json(cfg.to_json()),
                       device="cpu")
    eng.scorer = "fused_dv"
    ora, ref = OracleEngine(cfg), RefEngine(cfg)
    ref.scorer = "fused_dv" if kind == "bm25" else "xla"
    for e in (eng, ora, ref):
        e.build(docs[:60])
    want = ora.search(queries, k=10)
    for got, who in ((eng.search(queries, k=10), "port"),
                     (ref.search(queries, k=10), "reference")):
        np.testing.assert_array_equal(got[0], want[0], who)
        np.testing.assert_array_equal(got[1], want[1], who)
    plane = eng._dv_cache[0][2]
    seg = eng.segments[0][1]
    assert torch.equal(plane[:-8, :128], seg.post_doc)
    assert torch.equal(plane[:-8, 128:], seg.post_val)
    for e in (eng, ora):
        e.add_docs(docs[60:])
    # the refresh replaced every post_val and dropped the cached dv
    # planes, so none keeps an old plane resident
    assert not eng._dv_cache
    for k in (1, 17, 128, 200):
        want = ora.search(queries, k=k)
        got = eng.search(queries, k=k)
        np.testing.assert_array_equal(got[0], want[0], f"k={k}")
        np.testing.assert_array_equal(got[1], want[1], f"k={k}")
    assert len(eng._dv_cache) == 2
    assert eng._dv_cache[0][2] is not plane
