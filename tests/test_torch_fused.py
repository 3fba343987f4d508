"""The fused kernel's plain version (what ops/fused.py fused_search runs
on CPU tensors) against the reference's fused Pallas kernel in interpret
mode and its XLA twin search_packed_tables, on the same plan tables:
bit-identical (vals, docs) for k in {1, 10, 16}, with ties (a term row
repeated in two slots), missing slots, fully empty queries and skipped
blocks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from document_search_engine_tpu.ops import fused_pallas as ref_fused
from document_search_engine_tpu.ops.packed import (
    search_packed_tables as ref_tables,
)
from document_search_engine_tpu_torch.ops import fused as port_fused
from document_search_engine_tpu_torch.ops.packed import (
    search_packed_tables as port_tables,
)
from test_packed import make_aligned

SCALE = float(np.float32(2.0**16))
CLIP = float(np.float32(65075262.0))


def _case(seed, n_terms, n_docs, max_len, nq, s):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len, n_terms)
    indptr64 = np.zeros(n_terms + 1, np.int64)
    np.cumsum(lens, out=indptr64[1:])
    parts = [
        np.sort(rng.choice(n_docs, size=l, replace=False).astype(np.int32))
        for l in lens
    ]
    post_doc = np.concatenate(parts)
    post_val = rng.random(len(post_doc), dtype=np.float32) * 0.9 + 0.05
    indptr = indptr64.astype(np.int32)
    d2, v2, row_start = make_aligned(indptr, post_doc, post_val, n_docs)
    rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
    rows[:, -1] = rows[:, 0]  # duplicate term row => equal-doc ties
    coeff = (rng.random((nq, s)) * 1.5 + 0.05).astype(np.float32)
    coeff[rng.random((nq, s)) < 0.3] = 0.0  # missing slots
    coeff[1] = 0.0  # a fully empty query between real ones
    return d2, v2, row_start, indptr, rows, coeff


@pytest.mark.parametrize("k", [1, 10, 16])
def test_plain_version_matches_pallas_kernel(k):
    n_docs, nq, s, block = 2000, 4, 4, 256
    d2, v2, row_start, indptr, rows, coeff = _case(
        40 + k, 12, n_docs, 300, nq, s
    )
    lens = np.where(coeff > 0, indptr[rows + 1] - indptr[rows], 0)
    need = int((-(-lens // block)).sum(1).max())
    nb = 2 << int(np.ceil(np.log2(max(need, 1))))  # trailing blocks skip
    sr, rm, ab, dst = ref_fused.plan_tables(
        row_start, indptr, rows, coeff, nb, block
    )
    crows = ref_fused._compact_rows(rm[:, 0, :], block)
    r_c = 1 << int(np.ceil(np.log2(max(int(crows.sum(1).max()), 1))))
    want_v, want_d = ref_fused.fused_search_pallas(
        jnp.asarray(d2), jnp.asarray(v2), jnp.asarray(sr), jnp.asarray(rm),
        jnp.asarray(ab), jnp.asarray(dst), n_blocks=nb, block=block, s=s,
        k=k, n_docs=n_docs, scale=SCALE, clip=CLIP, r_c=r_c,
        q_stack=ref_fused.pick_stack(nq, r_c), interpret=True,
    )
    twin_v, twin_g = ref_tables(
        jnp.asarray(d2), jnp.asarray(v2), jnp.asarray(sr), jnp.asarray(rm),
        jnp.asarray(ab), jnp.float32(SCALE), jnp.float32(CLIP),
        jnp.int32(0), n_blocks=nb, block=block, s=s, k=k, n_docs=n_docs,
    )
    t = torch.from_numpy
    got_v, got_d = port_fused.fused_search(
        t(d2), t(v2), t(sr), t(rm), t(ab), t(dst), n_blocks=nb,
        block=block, s=s, k=k, n_docs=n_docs, scale=SCALE, clip=CLIP,
        r_c=r_c, key_bits=port_fused.key_bits_for(s, n_docs),
    )
    assert got_v.dtype == torch.int32 and got_v.shape == (nq, k)
    for want_pair in ((want_v, want_d), (twin_v, twin_g)):
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_pair[0]))
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_pair[1]))
    assert (got_v[1] == -1).all() and (got_v[0] > 0).any()


@pytest.mark.parametrize("doc_base", [0, 1000])
def test_plain_tables_match_xla_twin_with_doc_base(doc_base):
    """search_packed_tables itself (the engine's "plain" scorer) with a
    nonzero doc_base, block 4096 and a wider slot count."""
    n_docs, nq, s, block = 20000, 12, 8, 4096
    d2, v2, row_start, indptr, rows, coeff = _case(
        7 + doc_base, 30, n_docs, 6000, nq, s
    )
    lens = np.where(coeff > 0, indptr[rows + 1] - indptr[rows], 0)
    nb = 1 << int(np.ceil(np.log2(max(int((-(-lens // block)).sum(1).max()),
                                      1))))
    sr, rm, ab, _dst = ref_fused.plan_tables(
        row_start, indptr, rows, coeff, nb, block
    )
    want_v, want_g = ref_tables(
        jnp.asarray(d2), jnp.asarray(v2), jnp.asarray(sr), jnp.asarray(rm),
        jnp.asarray(ab), jnp.float32(SCALE), jnp.float32(CLIP),
        jnp.int32(doc_base), n_blocks=nb, block=block, s=s, k=10,
        n_docs=n_docs,
    )
    t = torch.from_numpy
    got_v, got_g = port_tables(
        t(d2), t(v2), t(sr), t(rm), t(ab), SCALE, CLIP, doc_base,
        n_blocks=nb, block=block, s=s, k=10, n_docs=n_docs,
    )
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
