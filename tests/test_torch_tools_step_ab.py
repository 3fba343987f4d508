"""The port's lever A/B (document_search_engine_tpu_torch/tools/
step_ab.py) on the CPU at a tiny size: every supported lever and a
combination serve the baseline's ids and scores, with a graph captured
after each apply when the engine keeps step graphs (a stand-in capturer
here); the kernel's stages, mirrored (ops/fused.py load_region, a sort,
ops/rank.py rank_merged), give the plain results at a coarser
GRANULE_ROWS; an unknown lever and the TPU's levers exit with their
reason; the module constants and engine fields are restored, also when a
setting raises; the card is asked for by default."""
import numpy as np
import pytest
import torch

from document_search_engine_tpu_torch import bench as B
from document_search_engine_tpu_torch.config import IndexConfig, ScoringConfig
from document_search_engine_tpu_torch.engine.step_graph import (
    StepGraphs,
    add_launch_counts,
    launch_counts,
)
from document_search_engine_tpu_torch.ops import fused as F
from document_search_engine_tpu_torch.ops import schedule as S
from document_search_engine_tpu_torch.ops.rank import rank_merged
from document_search_engine_tpu_torch.tools import roofline
from document_search_engine_tpu_torch.tools import step_ab as A

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

TINY = {"AB_DOCS": "3000", "AB_VOCAB": "2000", "AB_NQ": "16",
        "AB_ITERS": "1"}
LEVERS = ("block2048,dv,split128,split0,minblocks8,threads16,threads64,"
          "granule2,block1024+split64+threads0")


@pytest.fixture(scope="module")
def built():
    return B.build_synth_engine(
        3000, 2000, 60, IndexConfig(scoring=ScoringConfig(kind="bm25")),
        seed=1, device="cpu")


def fake_capture(step, static_in):
    """The CPU's stand-in for a CUDA graph (tests/test_torch_step_graph.py):
    a replay rewrites the static output from the static inputs."""
    static_out = step(*static_in)

    def replay():
        before = launch_counts()
        static_out.copy_(step(*static_in))
        add_launch_counts(tuple(b - a for a, b in
                                zip(launch_counts(), before)))

    return replay, static_out


def fields(eng):
    return (F.THREADS_BY_RC, F.GRANULE_ROWS, S.GRANULE_ROWS,
            eng.block_families, eng.scorer, eng.split_rows,
            eng.plan_min_blocks)


def test_every_lever_serves_the_baseline(built):
    eng = built[0]
    before = fields(eng)
    out = A.main(device="cpu", env=dict(TINY, STEP_AB=LEVERS), built=built)
    assert [r["name"] for r in out["results"]] == ["baseline",
                                                  *LEVERS.split(",")]
    for r in out["results"]:
        assert r["ms"] > 0 and r["captures"] == 0 and r["peak_bytes"] is None
    assert fields(eng) == before


def test_a_graph_captured_after_each_apply(built):
    eng = built[0]
    eng._graphs = StepGraphs("cpu", capturer=fake_capture)
    try:
        out = A.main(device="cpu", env=dict(
            TINY, STEP_AB="threads16,granule2,block2048+minblocks8"),
            built=built)
    finally:
        eng._graphs = None
    assert [r["captures"] >= 1 for r in out["results"]] == [True] * 4


def test_a_result_that_differs_fails(built, monkeypatch):
    step_only = B.step_only_qps

    def differing(eng, pre0, k, iters, depth, nq, label):
        qps, (ids, scores) = step_only(eng, pre0, k, iters, depth, nq, label)
        if label == "threads16":
            scores = scores.copy()
            scores[0, 0] += 1
        return qps, (ids, scores)

    monkeypatch.setattr(B, "step_only_qps", differing)
    with pytest.raises(AssertionError, match="threads16: ids or scores"):
        A.main(device="cpu", env=dict(TINY, STEP_AB="block2048,threads16"),
               built=built)


@pytest.mark.parametrize("spec", ["warp9", "block", "block2048,threadsX",
                                  "dv+cache4"])
def test_unknown_lever_exits(spec):
    # before any index is built
    with pytest.raises(SystemExit, match="unknown lever"):
        A.main(device="cpu", env=dict(TINY, STEP_AB=spec))


@pytest.mark.parametrize("lever,why", [
    ("depth16", "no DMA depth"), ("depth8", "no DMA depth"),
    ("stack32", "no MAX_STACK"), ("mergeflip", "merge path"),
    ("mergerev", "merge path"), ("ukeys", "(doc << kb) | slot"),
    ("noukeys", "(doc << kb) | slot"),
])
def test_tpu_levers_exit_with_their_reason(lever, why):
    for spec in (lever, f"block2048,{lever}", f"block2048+{lever}"):
        with pytest.raises(SystemExit) as e:
            A.main(device="cpu", env=dict(TINY, STEP_AB=spec))
        assert why in str(e.value) and lever in str(e.value)


def test_restored_when_a_setting_raises(built, monkeypatch):
    eng = built[0]
    before = fields(eng)
    step_only = B.step_only_qps

    def failing(eng_, pre0, k, iters, depth, nq, label):
        if label == "dv+threads64+granule2+minblocks16+split32":
            assert F.THREADS_BY_RC == ((64, 256), (None, 1024))
            assert F.GRANULE_ROWS == S.GRANULE_ROWS == 2
            raise RuntimeError("setting failed")
        return step_only(eng_, pre0, k, iters, depth, nq, label)

    monkeypatch.setattr(B, "step_only_qps", failing)
    with pytest.raises(RuntimeError, match="setting failed"):
        A.main(device="cpu", env=dict(
            TINY, STEP_AB="block2048,dv+threads64+granule2+minblocks16+"
            "split32"), built=built)
    assert fields(eng) == before
    assert F.THREADS_BY_RC == ((32, 256), (None, 1024))
    assert F.GRANULE_ROWS == S.GRANULE_ROWS == 1


@pytest.mark.parametrize("lever,tiled", [("tiled8", True),
                                         ("tiled1048576", False)])
def test_the_tiled_threshold_lever(built, monkeypatch, lever, tiled):
    """tiledN sets ops/fused.py TILED_MIN_RC for its setting: at 8 the
    batch's buckets take the tiled kernels (their plain mirror here), at
    2**20 none does; the answers equal the baseline's and the constant
    is restored."""
    from document_search_engine_tpu_torch.ops import tiled as T

    seen = []
    real = T.tiled_search_plain

    def counting(*a, **kw):
        seen.append(F.TILED_MIN_RC)
        return real(*a, **kw)

    monkeypatch.setattr(T, "tiled_search_plain", counting)
    before = F.TILED_MIN_RC
    out = A.main(device="cpu", env=dict(TINY, STEP_AB=lever), built=built)
    assert [r["name"] for r in out["results"]] == ["baseline", lever]
    assert F.TILED_MIN_RC == before
    assert (int(lever[5:]) in seen) == tiled


@pytest.mark.parametrize("granule", [1, 2, 4])
def test_kernel_mirror_at_a_coarser_granule(built, monkeypatch, granule):
    """The kernel's load stage and rank stage, mirrored, over every
    bucket the planner sizes at the granule: each query's region holds
    all its real pairs (the load cuts none), and the ranking equals the
    plain version's."""
    eng, _df, tokens_by_row = built
    monkeypatch.setattr(F, "GRANULE_ROWS", granule)
    monkeypatch.setattr(S, "GRANULE_ROWS", granule)
    _d, indptr, rows, _f, _p = roofline.workload(3000, 2000, 60, 16, 8)
    calls = roofline.dispatch_calls(eng, tokens_by_row, rows, 8)
    planes = (eng.segments[0][1].post_doc.numpy(),
              eng.segments[0][1].post_val.numpy())
    total = 0
    for seg, tabs, p in calls:
        vals, docs = F.fused_search(seg.post_doc, seg.post_val, *tabs, **p)
        region = F.load_region(planes, *tabs, block=p["block"],
                               r_c=p["r_c"], key_bits=p["key_bits"],
                               scale=p["scale"], clip=p["clip"])
        valid = torch.where(tabs[0] >= 0, tabs[1].clamp(0, p["block"]), 0)
        assert [len(w) for w, _o in region] == valid.sum((1, 2)).tolist()
        for q, (words, _off) in enumerate(region):
            v, d = rank_merged(torch.from_numpy(np.sort(words)), p["s"],
                               p["k"], p["n_docs"], p["key_bits"])
            assert torch.equal(v.to(torch.int32), vals[q])
            assert torch.equal(d.to(torch.int32), docs[q])
            total += len(words)
    lens = indptr[rows + 1] - indptr[rows]
    assert total == lens.sum()


def test_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        A.main(env=TINY)
