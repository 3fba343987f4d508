"""The fused kernel's load stage (csrc/fused_search.cu) through its plain
mirror in ops/fused.py: the plan table a query's warp builds
(load_units), the back-to-back region the load stage leaves for the rank
stage (load_region: the flattened int4 index over all units, from the
two planes or from the dv plane's rows), the buffer placement, and the
launch's thread count (launch_threads). The kernel needs a card;
this arithmetic does not. Plans come from expand_plan_tables over
chip_smoke.csr_from_lens inputs made from a numpy seed. The region is
held against the port's pack_tables words with the sentinels dropped, in
order, and, merged and ranked by the mirrors of csrc/rank.cuh, against
the JAX package's search_packed_tables on the same arrays."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from document_search_engine_tpu.ops.packed import (
    search_packed_tables as ref_tables,
)
from document_search_engine_tpu_torch.index import builder as B
from document_search_engine_tpu_torch.ops import fused as F
from document_search_engine_tpu_torch.ops.fused_dv import interleave_planes
from document_search_engine_tpu_torch.ops.packed import pack_tables
from document_search_engine_tpu_torch.ops.rank import (
    merge_region,
    rank_merged,
)
from test_torch_merge_model import chip_smoke

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

SCALE, CLIP = chip_smoke.SCALE, chip_smoke.CLIP
CASES = ("rem tails not a multiple of 4", "skipped blocks between real ones",
         "n exactly c", "n_blocks 128", "dlim pieces start below d_lo",
         "rows end at the plane's last row")


def _plan(rng, lens, rows, coeff, block, n_docs, extra=0):
    rows = np.asarray(rows, np.int32)
    coeff = np.asarray(coeff, np.float32)
    coeff[0] = 0.0  # an empty query in every case
    indptr, row_start, d2, v2 = chip_smoke.csr_from_lens(
        rng, lens, n_docs, n_docs)
    lens_q = np.where(coeff > 0, indptr[rows + 1] - indptr[rows], 0)
    need = int((-(-lens_q // block)).sum(1).max())
    nb = 1 << int(np.ceil(np.log2(max(need + extra, 1))))
    t = torch.from_numpy
    tabs = F.expand_plan_tables(t(row_start), t(indptr), t(rows),
                                t(coeff.view(np.int32)), nb, block)
    return dict(d2=d2, v2=v2, tabs=tabs, nb=nb, block=block,
                s=rows.shape[1], n_docs=n_docs, dlim=None, cut=None,
                row_start=row_start, indptr=indptr)


@functools.lru_cache(maxsize=None)
def case(name):
    """One load case: planes, plan tables and their shape."""
    rng = np.random.default_rng(CASES.index(name) + 17)
    ones = lambda nq, s: np.ones((nq, s), np.float32)
    if name == "rem tails not a multiple of 4":
        lens = [130, 257, 515, 1023, 7, 1, 2, 3]
        p = _plan(rng, lens, rng.integers(0, 8, (6, 4)), ones(6, 4), 256,
                  5000)
    elif name == "skipped blocks between real ones":
        lens = rng.integers(600, 2000, 6) | 1
        p = _plan(rng, lens, rng.integers(0, 6, (6, 4)), ones(6, 4), 256,
                  6000, extra=4)
        p["tabs"] = chip_smoke.reorder_blocks(p["tabs"], 256, rng, False,
                                              0.35)
    elif name == "n exactly c":
        # 2,048 and 1,024 + 1,024 postings: r_c 16 holds them exactly
        p = _plan(rng, [2048, 1024, 1024, 500], [[3, 3], [0, 3], [1, 2]],
                  ones(3, 2) * np.float32([[1, 1], [1, 0], [1, 1]]), 512,
                  9000)
    elif name == "n_blocks 128":
        # four slots of 32 blocks of 128: the plan scan's fourth warp step
        p = _plan(rng, [4096, 4096, 4096, 4000], [[0, 1, 2, 3]] * 3,
                  ones(3, 4), 128, 20000)
    elif name == "dlim pieces start below d_lo":
        n_docs, block, s, nq, m = 6000, 256, 4, 5, 4
        lens = rng.integers(300, 1500, 8) | 1
        indptr, row_start, d2, v2 = chip_smoke.csr_from_lens(
            rng, lens, n_docs, n_docs)
        t = torch.from_numpy
        q_p = B.SPLIT_QUANTILES
        offs = B.device_row_doc_quantiles(t(d2), t(indptr), t(row_start),
                                          q_p, n_docs)
        rows = np.repeat(rng.integers(0, 8, (nq, s)).astype(np.int32), m, 0)
        coeff = np.ones(rows.shape, np.float32)
        coeff[:m] = 0.0
        pno = np.tile(np.arange(m), nq)
        cols = np.stack([pno * q_p // m, (pno + 1) * q_p // m], 1)
        cols = cols.astype(np.int32)
        lo = offs.numpy()[rows, cols[:, 0:1]]
        assert ((lo % 128 != 0) & (coeff > 0)).any()
        lens_p = offs.numpy()[rows, cols[:, 1:2]] - (lo - lo % 128)
        nb = 1 << int(np.ceil(np.log2(int((-(-lens_p // block)).sum(1)
                                          .max()))))
        tabs = F.expand_plan_tables(
            t(row_start), t(indptr), t(rows), t(coeff.view(np.int32)), nb,
            block, offs_dev=offs, cols=t(cols))
        dlim = (cols.astype(np.int64) * n_docs // q_p).astype(np.int32)
        p = dict(d2=d2, v2=v2, tabs=tabs, nb=nb, block=block, s=s,
                 n_docs=n_docs, dlim=dlim.reshape(-1, 1, 2), cut=None)
    else:  # the last term's rows end where the cut planes end
        lens = [700, 900, 333]
        p = _plan(rng, lens, [[0, 1], [2, 1], [2, 2], [0, 2]], ones(4, 2),
                  256, 4000)
        end = int(p["row_start"][2]) + 333
        p["cut"] = -(-end // 128)
    p["r_c"] = chip_smoke.tight_rc(p["tabs"][1], p["block"])
    p["tabs"] = [x.numpy() for x in p["tabs"]]
    return p


def planes_of(p, dv):
    """The planes the kernel reads: cut after the last real row where the
    case says so (the plain pack reads whole blocks and keeps them)."""
    d2, v2 = p["d2"], p["v2"]
    if p["cut"] is not None:
        d2, v2 = d2[: p["cut"]], v2[: p["cut"]]
    if dv:
        return (interleave_planes(torch.from_numpy(d2),
                                  torch.from_numpy(v2)).numpy(),)
    return d2, v2


def packed_words(p, kb):
    """pack_tables' candidates as the kernel keys them, per query, the
    sentinels dropped, in order: (doc << kb) | slot, and ci 0 for a doc
    outside the query's limits (its key kept)."""
    t = torch.from_numpy
    sr, rm, ab, dst = (t(x) for x in p["tabs"])
    args = (t(p["d2"]), t(p["v2"]), sr, rm, ab, SCALE, CLIP, p["nb"],
            p["block"], p["n_docs"])
    d_key, ci = pack_tables(*args)
    if p["dlim"] is not None:
        ci = pack_tables(*args, dlim=t(p["dlim"]))[1]
    nq = d_key.shape[0]
    slot = (dst.reshape(nq, p["nb"]) >> F.SLOT_SHIFT).long()
    slot = slot.repeat_interleave(p["block"], dim=1)
    key = ((d_key.long() << kb) | slot) if kb else d_key.long()
    words = (key << 32) | ci.long()
    real = d_key < p["n_docs"]
    return [words[q][real[q]].numpy() for q in range(nq)]


def key_bits(p, kbm):
    return F.key_bits_for(p["s"], p["n_docs"]) if kbm == "auto" else 0


@pytest.mark.parametrize("kbm", ["auto", "zero"])
@pytest.mark.parametrize("dv", [False, True], ids=["planes", "dv"])
@pytest.mark.parametrize("name", CASES)
def test_region_equals_packed_words(name, dv, kbm):
    p = case(name)
    kb = key_bits(p, kbm)
    got = F.load_region(planes_of(p, dv), *p["tabs"], p["dlim"],
                        block=p["block"], r_c=p["r_c"], key_bits=kb,
                        scale=SCALE, clip=CLIP)
    want = packed_words(p, kb)
    for q, ((words, off), w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(words, w, f"query {q}")
        assert off[0] == 0 and off[-1] == len(w)
        assert (np.diff(off) > 0).all()  # units hold a posting each
    assert len(got[0][0]) == 0  # the empty query
    if name == "n exactly c":
        assert max(len(w) for w in want) == p["r_c"] * F.LANES
    if name == "n_blocks 128":
        assert p["nb"] == 128 and max(len(u["off"]) - 1 for u in F.load_units(
            *p["tabs"], block=p["block"], r_c=p["r_c"])) > 96


@pytest.mark.parametrize("kbm", ["auto", "zero"])
@pytest.mark.parametrize("name", CASES)
def test_region_ranks_like_reference(name, kbm):
    """The region merged by merge-path levels at the launch's thread
    count and ranked (run-sums, top-k) equals the JAX package's
    search_packed_tables on the same arrays, at k 10 and 17."""
    p = case(name)
    kb = key_bits(p, kbm)
    region = F.load_region(planes_of(p, False), *p["tabs"], p["dlim"],
                           block=p["block"], r_c=p["r_c"], key_bits=kb,
                           scale=SCALE, clip=CLIP)
    for k in (10, 17):
        threads = F.launch_threads(p["r_c"])
        j = jnp.asarray
        want = ref_tables(
            j(p["d2"]), j(p["v2"]), *(j(x) for x in p["tabs"][:3]),
            jnp.float32(SCALE), jnp.float32(CLIP), jnp.int32(0),
            n_blocks=p["nb"], block=p["block"], s=p["s"], k=k,
            n_docs=p["n_docs"],
            dlim=None if p["dlim"] is None else j(p["dlim"]))
        want = [np.asarray(x) for x in want]
        for q, (words, off) in enumerate(region):
            merged, n_runs, _levels = merge_region(words.tolist(),
                                                   off.tolist(),
                                                   threads=threads)
            assert n_runs <= len(off) - 1
            vals, docs = rank_merged(merged, p["s"], k, p["n_docs"], kb)
            np.testing.assert_array_equal(vals.numpy(), want[0][q])
            np.testing.assert_array_equal(docs.numpy(), want[1][q])


@pytest.mark.parametrize("name", CASES)
def test_unit_table(name):
    """The plan table: one unit per plan block that holds a posting, in
    plan order, its int4 words ceil(valid / 4) of one plane, its row,
    coefficient and slot those of its block; the region is the blocks'
    postings (no cut: the planner's r_c holds them)."""
    p = case(name)
    sr, rm, ab, dst = (x.reshape(x.shape[0], -1) for x in p["tabs"])
    for q, t in enumerate(F.load_units(*p["tabs"], block=p["block"],
                                       r_c=p["r_c"])):
        valid = np.where(sr[q] >= 0, np.clip(rm[q], 0, p["block"]), 0)
        live = valid > 0
        assert (np.diff(t["off"]) == valid[live]).all()
        assert (np.diff(t["q4"]) == -(-valid[live] // 4)).all()
        assert (t["src"] == sr[q][live]).all()
        assert (t["coeff"] == ab[q][live]).all()
        assert (t["slot"] == dst[q][live] >> F.SLOT_SHIFT).all()
        assert t["off"][-1] == valid.sum() <= p["r_c"] * F.LANES


def test_region_is_cut_at_c():
    """A region smaller than its postings keeps the first c pairs, in
    plan order, and no unit past them (the kernel never stores past c)."""
    p = case("rem tails not a multiple of 4")
    full = F.load_region(planes_of(p, False), *p["tabs"], block=p["block"],
                         r_c=p["r_c"], key_bits=0, scale=SCALE, clip=CLIP)
    cut = F.load_region(planes_of(p, False), *p["tabs"], block=p["block"],
                        r_c=1, key_bits=0, scale=SCALE, clip=CLIP)
    for (fw, _fo), (cw, co) in zip(full, cut):
        n = min(len(fw), F.LANES)
        np.testing.assert_array_equal(cw, fw[:n])
        assert co[-1] == n and (np.diff(co) > 0).all()


def test_reads_stay_inside_the_plane():
    """The last term's int4 reads end inside planes cut right after its
    last row, and inside the dv plane's pad rows; one row less and they
    would not."""
    p = case("rows end at the plane's last row")
    kw = dict(block=p["block"], r_c=p["r_c"], key_bits=0, scale=SCALE,
              clip=CLIP)
    for dv in (False, True):
        F.load_region(planes_of(p, dv), *p["tabs"], **kw)
    short = (p["d2"][: p["cut"] - 1], p["v2"][: p["cut"] - 1])
    with pytest.raises(IndexError):
        F.load_region(short, *p["tabs"], **kw)


# the main path's buckets (PERF.md §5: [n_blocks, r_c], a query's real
# pairs at the bucket's max or mean) and where such a query's buffers lie
MAIN_QUERIES = [
    ((8, 16), 1843, "shared"), ((8, 32), 3857, "shared"),
    ((8, 64), 7727, "shared"), ((16, 64), 7898, "shared"),
    ((16, 128), 10206, "shared"), ((16, 128), 15993, "first"),
    ((16, 256), 20651, "first"), ((32, 512), 62234, "workspace"),
]


@pytest.mark.parametrize("shape,n,where", MAIN_QUERIES)
def test_main_path_placement(shape, n, where):
    nb, r_c = shape
    assert F.placement(n, F.buffer_words(r_c, nb)) == where


def test_placement_edges():
    """place_buffers around its two capacities, at the capped r_c 256."""
    w = F.buffer_words(256, 8)
    assert w == (F.SMEM_MAX_BYTES - F.plan_table_bytes(8)) // 8
    assert [F.placement(n, w) for n in (w // 2, w // 2 + 1, w, w + 1)] == [
        "shared", "first", "first", "workspace"]
    assert F.fused_smem_bytes(16, 8) == F.plan_table_bytes(8) + 16 * 2048
    assert F.plan_table_bytes(8) == 176 and F.plan_table_bytes(1) == 32


# every bucket shape of PERF.md §5 the fused kernel runs ([nq, n_blocks,
# block, r_c]: k = 10 and 64, the dv plane, and dlim at split 128, whose
# r_c 16 to 256 are among them) and its thread count
MAIN_BUCKETS = [
    ([7104, 8, 4096, 16], 256), ([6704, 8, 4096, 32], 256),
    ([1808, 8, 4096, 64], 1024), ([608, 16, 4096, 64], 1024),
    ([864, 16, 4096, 128], 1024), ([368, 16, 4096, 256], 1024),
    ([48, 32, 4096, 512], 1024),
]


@pytest.mark.parametrize("bucket,threads", MAIN_BUCKETS)
def test_launch_threads_of_main_buckets(bucket, threads):
    assert F.launch_threads(bucket[3]) == threads


def test_launch_threads_each_side_of_each_threshold():
    """The first entry of THREADS_BY_RC whose bound holds: at a bound its
    own count, one power of two above it the next entry's; the last entry
    takes everything larger."""
    table = F.THREADS_BY_RC
    assert table[-1][0] is None
    assert [t for _b, t in table] == sorted(t for _b, t in table)
    for (bound, threads), (_next, above) in zip(table, table[1:]):
        assert F.launch_threads(bound) == threads
        assert F.launch_threads(bound // 2) == threads
        assert F.launch_threads(2 * bound) == above
    assert F.launch_threads(1) == table[0][1]
    assert F.launch_threads(1 << 14) == table[-1][1]
    assert table[0] == (32, 256) and table[-1][1] == 1024
