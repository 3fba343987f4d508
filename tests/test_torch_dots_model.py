"""The rerank dots kernel's layout (csrc/rerank_dots.cu) through its plain
mirror in ops/rerank.py: the launch shape the wrapper chooses (dots_vec,
dots_launch), which query, candidate and chunk every (block, thread,
slot, round) reads (dots_reads), and the dots and norms assembled through
the gid phase, the lanes' products, the xor butterfly within each lane
group, lane 0's staging and the coalesced write (gather_and_dot_mirror).
The kernel needs a card; this arithmetic does not. Inputs are made from a
numpy seed; the assembled results are held against gather_and_dot_plain
and the JAX package's gather_and_dot (its Pallas kernel in interpret
mode). Every compared value is an integer: tolerance 0."""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from document_search_engine_tpu.ops import rerank as ref_rerank
from document_search_engine_tpu_torch.ops import rerank as R

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

DIMS, KS = (64, 100, 256, 1024), (1, 10, 16, 64, 65, 200)
# (dim, bytes a load): dim 100 takes only the 4-byte loads
SHAPES = [(dim, vec) for dim in DIMS for vec in (4, 16) if dim % vec == 0]
# 9 queries: a multiple of no queries a block above 1
NQ, N_DOCS = 9, 40
CSRC = Path(R.__file__).resolve().parent.parent / "csrc" / "rerank_dots.cu"


@functools.lru_cache(maxsize=None)
def inputs(dim, kc):
    """(emb, ssq, qemb, gids) numpy arrays: dead (-1) and repeated gids,
    a query with no live candidate, and the table's last row."""
    rng = np.random.default_rng(dim * 1000 + kc)
    clip = R.EMB_CLIP
    emb = rng.integers(-clip, clip + 1, (N_DOCS, dim)).astype(np.int8)
    ssq = (emb.astype(np.int32) ** 2).sum(1).astype(np.int32)
    qemb = rng.integers(-clip, clip + 1, (NQ, dim)).astype(np.int8)
    gids = rng.integers(0, N_DOCS, (NQ, kc)).astype(np.int32)
    gids[rng.random((NQ, kc)) < 0.2] = -1
    gids[:, -1] = gids[:, 0]
    gids[1, kc // 2] = N_DOCS - 1
    gids[2] = -1
    return emb, ssq, qemb, gids


@functools.lru_cache(maxsize=None)
def reference(dim, kc):
    """The JAX package's gather_and_dot (interpret mode), as numpy."""
    emb, ssq, qemb, gids = inputs(dim, kc)
    out = ref_rerank.gather_and_dot(
        jnp.asarray(emb), jnp.asarray(ssq), jnp.asarray(qemb),
        jnp.asarray(gids), interpret=True,
    )
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("kc", KS)
@pytest.mark.parametrize("dim,vec", SHAPES)
def test_reads_cover_each_candidate_chunk_once(dim, vec, kc):
    lay = R.dots_launch(NQ, kc, dim, vec)
    r = R.dots_reads(NQ, kc, dim, vec)
    live = r["live"]
    q, j, c = r["q"][live], r["j"][live], r["c"][live]
    assert (q < NQ).all() and (j < kc).all() and (c < dim // vec).all()
    seen = np.zeros((NQ, kc, dim // vec), np.int64)
    np.add.at(seen, (q, j, c), 1)
    assert (seen == 1).all()
    # a live read's cell is the one the write phase maps to its (q, j)
    bx = np.broadcast_to(np.arange(lay["grid"][0])[:, None, None, None,
                                                   None], live.shape)[live]
    by = np.broadcast_to(np.arange(lay["grid"][1])[None, :, None, None,
                                                   None], live.shape)[live]
    cell = r["cell"][live]
    assert (bx * lay["qb"] + cell // lay["tile"] == q).all()
    assert (by * lay["tile"] + cell % lay["tile"] == j).all()
    # lanes past the row's last chunk and slots past K read nothing
    assert (r["c"][r["slot_live"] & ~live] >= dim // vec).all()


@pytest.mark.parametrize("kc", KS)
@pytest.mark.parametrize("dim,vec", SHAPES)
def test_mirror_matches_plain_and_jax(dim, vec, kc):
    emb, ssq, qemb, gids = inputs(dim, kc)
    got = R.gather_and_dot_mirror(emb, ssq, qemb, gids, vec)
    plain = R.gather_and_dot_plain(*map(torch.from_numpy,
                                        (emb, ssq, qemb, gids)))
    for g, p, w in zip(got, plain, reference(dim, kc)):
        assert g.dtype == np.int32 and g.shape == (NQ, kc)
        np.testing.assert_array_equal(g, p.numpy())
        np.testing.assert_array_equal(g, w)


def test_vector_width_from_dim_and_alignment():
    assert R.dots_vec(256, 0, 512) == 16
    assert R.dots_vec(1024) == 16
    assert R.dots_vec(100, 0, 0) == 4  # dim not a multiple of 16
    assert R.dots_vec(256, 4, 0) == 4  # emb 4 bytes past 16-byte alignment
    assert R.dots_vec(256, 0, 20) == 4


@pytest.mark.parametrize("dim,vec", SHAPES)
def test_launch_shape(dim, vec):
    chunks = dim // vec
    for kc in KS:
        lay = R.dots_launch(NQ, kc, dim, vec)
        lanes = lay["lanes"]
        assert lanes & (lanes - 1) == 0 and lanes <= 32
        assert lanes >= min(chunks, 32) and (lanes == 32 or lanes < 2 * chunks)
        assert lay["rounds"] * lanes >= chunks
        assert lay["rounds"] == 1 or lanes == 32
        assert lay["qb"] * lay["tile"] == lay["groups"] * R.DOTS_SLOTS
        # several queries a block only where each one's tile holds all K
        assert lay["qb"] == 1 or lay["tile"] >= kc
        assert lay["grid"] == (-(-NQ // lay["qb"]), -(-kc // lay["tile"]))
    # the rerank path: dim 256, K 64: one query a block, all 64 candidates
    # as 16 groups of 16 lanes, 4 rows each, one 16-byte load a row
    lay = R.dots_launch(16384, 64, 256, 16)
    assert (lay["lanes"], lay["rounds"], lay["qb"], lay["tile"],
            lay["grid"]) == (16, 1, 1, 64, (16384, 1))


def test_mirror_constants_match_the_kernel():
    src = CSRC.read_text()
    for name, value in (("kDotsThreads", R.DOTS_THREADS),
                        ("kDotsSlots", R.DOTS_SLOTS)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
