"""The merge arithmetic of csrc/rank.cuh through its plain mirrors in
ops/rank.py (natural_run_starts, corank, merge_path_sort): the kernels
need a card, their index arithmetic does not. Inputs are the rows that
chip_smoke.py's phase 2 aims at the merge on the card (merge_rank_rows,
rows_with_real_pairs), made from a numpy seed; pure torch and numpy."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from document_search_engine_tpu_torch.ops import fused as port_fused
from document_search_engine_tpu_torch.ops.packed import pack_tables
from document_search_engine_tpu_torch.ops.rank import (
    corank,
    merge_path_sort,
    natural_run_starts,
    real_lengths,
)

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

C, RUN, N_DOCS = 2048, 256, 8192
SENTINEL = N_DOCS << 32
ROW_NAMES, _D, _CI, _S = chip_smoke.merge_rank_rows(
    np.random.default_rng(11), C, RUN, N_DOCS)
# natural runs of each row: a break at every run boundary is the worst
# case (C / RUN), equal docs in 8 runs tie on the key (kb = 0)
WANT_RUNS = {"one run": 1, "break at every run": 8,
             "1 pair beside a long run": 2, "three natural runs": 3,
             "sentinel runs between": 3, "equal docs in 8 runs": 8,
             "one warp's stretch": 1, "one thread's positions": 1}


def words_of(d, ci):
    return (torch.from_numpy(d).long() << 32) | torch.from_numpy(ci).long()


def check_sorts(w, granule, sentinel, **kw):
    got, n_runs, levels = merge_path_sort(w, granule, sentinel=sentinel, **kw)
    n = int((w < sentinel).sum())
    assert torch.equal(got, torch.sort(w).values[:n])
    assert n_runs == int(natural_run_starts(w, granule, sentinel).sum())
    assert levels == (0 if n_runs <= 1 else int(np.ceil(np.log2(n_runs))))
    return n_runs


@pytest.mark.parametrize("name", ROW_NAMES)
def test_merge_path_sort_equals_sort(name):
    row = ROW_NAMES.index(name)
    w = words_of(_D[row], _CI[row])
    for threads in (512, 7):  # the kernel's stretch, and long stretches
        n_runs = check_sorts(w, RUN, SENTINEL, threads=threads)
    if name in WANT_RUNS:
        assert n_runs == WANT_RUNS[name]
    assert n_runs <= C // RUN


@pytest.mark.parametrize("stretch", [1, 2, 5, 64, 2049])
def test_merge_path_sort_any_stretch(stretch):
    """Even stretches, stretches across several groups of a level, and
    one thread that takes the whole row."""
    row = ROW_NAMES.index("break at every run")
    w = words_of(_D[row], _CI[row])
    threads = -(-C // stretch)
    check_sorts(w, RUN, SENTINEL, stretch=stretch, threads=threads)


def test_merge_path_sort_without_sentinel():
    """Every word real: random full runs, and an odd number of them."""
    rng = np.random.default_rng(3)
    runs = [np.sort(rng.integers(0, 1 << 40, 64)) for _ in range(7)]
    w = torch.from_numpy(np.concatenate(runs))
    got, n_runs, levels = merge_path_sort(w, 64, threads=32)
    assert torch.equal(got, torch.sort(w).values)
    assert (n_runs, levels) == (7, 3)


def capacity_edges():
    """Real pairs one under, at and one over the two capacities of a
    C = 32,768, run = 1,024 launch (both buffers in shared memory; the
    first only): csrc/rank.cuh region_smem_bytes with its 224 KiB cap."""
    c, run = 32768, 1024
    table = (c // run + 2) // 2
    sw = min(table * 8 + c * 16, 224 * 1024) // 8 - table
    return [sw // 2 - 1, sw // 2, sw // 2 + 1, sw - 1, sw, sw + 1]


@pytest.mark.parametrize("n", capacity_edges())
def test_merge_path_sort_around_capacity(n):
    c, run, n_docs = 32768, 1024, 4 * 32768
    d, ci = chip_smoke.rows_with_real_pairs(
        np.random.default_rng(n), c, run, n_docs, [n])
    w = words_of(d[0], ci[0])
    assert int(real_lengths(w, run, n_docs << 32).sum()) == n
    assert check_sorts(w, run, n_docs << 32) == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corank_splits(seed):
    """Splits are monotone in the diagonal, sum to it, and cut the merge:
    everything taken is <= everything left."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.integers(0, 40, int(rng.integers(0, 60)))).tolist()
    y = np.sort(rng.integers(0, 40, int(rng.integers(1, 60)))).tolist()
    merged = sorted(x + y)
    prev = 0
    for diag in range(len(x) + len(y) + 1):
        i = corank(x, y, diag)
        j = diag - i
        assert prev <= i <= prev + 1 and 0 <= j <= len(y)
        assert sorted(x[:i] + y[:j]) == merged[:diag]
        if i and j < len(y):  # ties come from x first
            assert x[i - 1] <= y[j]
        if j and i < len(x):
            assert y[j - 1] < x[i]
        prev = i


@pytest.mark.parametrize("block,s,reverse", [(256, 4, False), (128, 8, False),
                                             (512, 2, False), (128, 4, True)])
def test_natural_runs_of_packed_plans(block, s, reverse):
    """expand_plan_tables + pack_tables: a query is at most s natural
    runs (one per live slot) however many blocks it spans; with the
    blocks reversed every block is its own run."""
    rng = np.random.default_rng(block + s)
    n_docs, nq = 4000, 6
    lens = rng.integers(1, 900, 10)
    indptr, row_start, d2, v2 = chip_smoke.csr_from_lens(
        rng, lens, n_docs, n_docs)
    rows = rng.integers(0, 10, (nq, s)).astype(np.int32)
    coeff = (rng.random((nq, s)) + 0.1).astype(np.float32)
    coeff[0, 0] = 0.0
    lens_q = np.where(coeff > 0, indptr[rows + 1] - indptr[rows], 0)
    nb = 1 << int(np.ceil(np.log2(int((-(-lens_q // block)).sum(1).max()))))
    t = torch.from_numpy
    tabs = port_fused.expand_plan_tables(
        t(row_start), t(indptr), t(rows), t(coeff.view(np.int32)), nb, block)
    if reverse:
        tabs = chip_smoke.reorder_blocks(tabs, block, rng, True, 0.0)
    d_key, ci = pack_tables(t(d2), t(v2), *tabs[:3], chip_smoke.SCALE,
                            chip_smoke.CLIP, nb, block, n_docs)
    words = (d_key.long() << 32) | ci.long()
    runs = natural_run_starts(words, block, n_docs << 32).sum(1).numpy()
    blocks = (-(-lens_q // block)).sum(1)
    if reverse:
        multi = (-(-lens_q // block)).max(1) > 1
        assert (runs[multi] > (coeff[multi] > 0).sum(1)).all() and multi.any()
        assert (runs <= blocks).all()
    else:
        assert (runs <= (coeff > 0).sum(1)).all()
        assert (blocks > s).any()  # some slot spans several blocks
    for q in range(nq):
        check_sorts(words[q], block, n_docs << 32, threads=16)
