"""The torch port's planners against the reference: the device-side
expansion of the fused kernel's plan tables must equal the reference's
host planner under a seeded fuzz (as tests/test_plan_fuzz.py fuzzes the
reference's own twin), and the port's bucketing must equal the
reference's plan_batch."""
import numpy as np
import pytest
import torch

from document_search_engine_tpu.ops import fused_pallas as ref_fused
from document_search_engine_tpu.ops import schedule as ref_schedule
from document_search_engine_tpu_torch.ops import fused as port_fused
from document_search_engine_tpu_torch.ops import schedule as port_schedule
from test_packed import make_aligned

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)


def _fuzz_csr(rng):
    n_terms = int(rng.integers(5, 60))
    n_docs = int(rng.integers(50, 4000))
    max_len = int(rng.integers(2, min(n_docs, 1500)))
    lens = rng.integers(0, max_len, n_terms)  # includes empty rows
    indptr64 = np.zeros(n_terms + 1, np.int64)
    np.cumsum(lens, out=indptr64[1:])
    parts = [
        np.sort(rng.choice(n_docs, size=l, replace=False).astype(np.int32))
        for l in lens
    ]
    post_doc = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    post_val = rng.random(len(post_doc), dtype=np.float32) + 0.05
    indptr = indptr64.astype(np.int32)
    _d2, _v2, row_start = make_aligned(indptr, post_doc, post_val, n_docs)
    return n_terms, indptr, row_start


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
def test_expand_plan_tables_fuzz(seed):
    rng = np.random.default_rng(seed)
    n_terms, indptr, row_start = _fuzz_csr(rng)
    nq = int(rng.integers(1, 40))
    s = int(rng.choice([1, 2, 4, 8, 16, 32]))
    rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
    coeff = rng.random((nq, s)).astype(np.float32) * 2.0
    coeff[rng.random((nq, s)) < 0.25] = 0.0  # missing slots
    block = int(rng.choice([256, 512, 1024, 2048, 4096]))
    lens = np.where(coeff > 0, indptr[rows + 1] - indptr[rows], 0)
    need = int((-(-lens // block)).sum(1).max())
    # budgets at and above the need: trailing blocks are skipped
    nb = 1 << int(np.ceil(np.log2(max(need, 1)))) + int(rng.integers(0, 2))
    want = ref_fused.plan_tables(row_start, indptr, rows, coeff, nb, block)
    got = port_fused.expand_plan_tables(
        torch.from_numpy(row_start), torch.from_numpy(indptr),
        torch.from_numpy(rows), torch.from_numpy(coeff.view(np.int32)),
        nb, block,
    )
    for name, g, w in zip(("srcrow", "rem", "abits", "dstrow"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, f"{name} seed={seed}")


def test_expand_plan_tables_empty_segment():
    rows = torch.zeros((5, 4), dtype=torch.int32)
    cb = torch.ones((5, 4), dtype=torch.float32).view(torch.int32)
    got = port_fused.expand_plan_tables(
        torch.zeros(0, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
        rows, cb, 8, 1024,
    )
    want = ref_fused.plan_tables(
        np.zeros(0, np.int32), np.zeros(1, np.int32), rows.numpy(),
        cb.view(torch.float32).numpy(), 8, 1024,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize(
    "families,compact",
    [
        (ref_schedule.FUSED_FAMILIES, True),
        (ref_schedule.FUSED_FAMILIES, False),
        (ref_schedule.DEFAULT_FAMILIES, False),
    ],
)
def test_plan_batch_matches_reference(families, compact):
    rng = np.random.default_rng(17)
    lens = np.concatenate([
        rng.integers(0, 60, 300), rng.integers(500, 40_000, 40),
        np.zeros(5, np.int64),
    ])
    indptr = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    rows = rng.integers(0, len(lens), (700, 8)).astype(np.int32)
    found = rng.random((700, 8)) > 0.2
    assert port_schedule.FUSED_FAMILIES == ref_schedule.FUSED_FAMILIES
    assert port_schedule.DEFAULT_FAMILIES == ref_schedule.DEFAULT_FAMILIES
    want = ref_schedule.plan_batch(
        indptr, rows, found, families=families, compact=compact
    )
    got = port_schedule.plan_batch(
        indptr, rows, found, families=families, compact=compact
    )
    assert len(got) == len(want) > 2
    for (gi, gnb, gblk, grc), (wi, wnb, wblk, wrc) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert (gnb, gblk, grc) == (wnb, wblk, wrc)
    assert sum(len(p[0]) for p in got) == len(rows)
