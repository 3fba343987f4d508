"""The port's per-stage roofline (document_search_engine_tpu_torch/tools/
roofline.py) on the CPU at a small size: its reconstructed workload (the
Zipf df, the query rows and the natural buckets) equals the one the
repo-root tools/roofline.py builds from the repo-root bench.zipf_df and
the JAX package's ops/schedule.py plan_batch; its real postings equal
the sum over a CPU engine's captured bucket tables for the same rows;
its merge levels, natural runs (against ops/rank.py merge_region), the
fewest steps of the merge's binary searches, the radix select's passes
and the buffer placement (ops/fused.py placement) follow the kernel; on
the CPU its peaks are the data sheet's; host-only mode builds no index;
the card is asked for by default."""
import contextlib
import importlib.util
import io
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from document_search_engine_tpu.ops.schedule import FUSED_FAMILIES as REF_FAM
from document_search_engine_tpu.ops.schedule import plan_batch as ref_plan
from document_search_engine_tpu_torch import bench as B
from document_search_engine_tpu_torch.config import IndexConfig, ScoringConfig
from document_search_engine_tpu_torch.ops import fused as F
from document_search_engine_tpu_torch.ops.rank import merge_region
from document_search_engine_tpu_torch.tools import roofline as R

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DOCS, VOCAB, AVG, NQ = 3000, 2000, 60, 24
SMALL = {"BENCH_DOCS": str(DOCS), "BENCH_VOCAB": str(VOCAB),
         "BENCH_NQ": str(NQ)}


def _load_reference_bench():
    """The repo-root bench.py, loaded as tests/test_torch_bench.py does."""
    sp = importlib.util.spec_from_file_location(
        "dse_bench_roofline_reference", REPO / "bench.py")
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def built():
    return B.build_synth_engine(
        DOCS, VOCAB, AVG, IndexConfig(scoring=ScoringConfig(kind="bm25")),
        seed=1, device="cpu")


def quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


@pytest.mark.parametrize("docs,vocab,nq", [(20_000, 4000, 256),
                                           (1_000_000, 200_000, 512)])
def test_workload_equals_the_original(docs, vocab, nq):
    ref = _load_reference_bench()
    df, indptr, rows, found, plans = R.workload(docs, vocab, 60, nq, 8)
    # tools/roofline.py's reconstruction, step for step
    ref_df = ref.zipf_df(docs, vocab, 60)
    ref_ptr = np.zeros(vocab + 1, np.int64)
    np.cumsum(ref_df.astype(np.int64), out=ref_ptr[1:])
    ref_ptr = ref_ptr.astype(np.int32)
    rng = np.random.default_rng(7)
    eligible = np.where((ref_df >= 64) & (ref_df <= 32768))[0]
    ref_rows = rng.choice(eligible, size=(nq, 8))
    want = ref_plan(ref_ptr, ref_rows, np.ones((nq, 8), bool),
                    families=REF_FAM, min_blocks=4, compact=True)
    assert np.array_equal(df, ref_df) and np.array_equal(indptr, ref_ptr)
    assert np.array_equal(rows, ref_rows) and found.all()
    assert len(plans) == len(want) > 1
    for (idx, nb, blk, rc), (w_idx, w_nb, w_blk, w_rc) in zip(plans, want):
        assert np.array_equal(idx, w_idx)
        assert (nb, blk, rc) == (w_nb, w_blk, w_rc)


def test_real_postings_equal_the_captured_tables(built):
    out = quiet(R.main, device="cpu", env=SMALL, built=built)
    _df, indptr, rows, _f, plans = R.workload(DOCS, VOCAB, AVG, NQ, 8)
    natural = int((indptr[rows + 1] - indptr[rows]).sum())
    calls = R.dispatch_calls(built[0], built[2], rows, 8)
    tables = sum(
        int(torch.where(t[0] >= 0, t[1].clamp(0, p["block"]), 0).sum())
        for _s, t, p in calls)
    assert out["real_postings"] == {"natural": natural, "captured": natural}
    assert tables == natural
    assert sum(a["real_pairs"] for a in out["host"]) == natural
    assert out["natural_buckets"] == [[len(i), nb, b, rc]
                                      for i, nb, b, rc in plans]
    # the card's measures are the card's
    assert all(a["ms"] is None and a["blocks_per_sm"] is None
               for a in out["card"])
    for a in out["host"] + out["card"]:
        assert a["bound_ms"] > 0 and a["stage_sum_ms"] >= a["bound_ms"]
        assert a["dominant"] in R.STAGES


def test_host_only_builds_no_index(monkeypatch):
    def no_build(*a, **kw):
        raise AssertionError("built an index")

    monkeypatch.setattr(B, "build_synth_engine", no_build)
    out = quiet(R.main, device="cpu", env=dict(SMALL, ROOF_CARD="0"))
    assert out["card"] is None and out["host"]


def test_merge_levels():
    assert [R.merge_levels(r) for r in range(10)] == [
        0, 0, 1, 2, 2, 3, 3, 3, 3, 4]
    for runs in (2, 3, 7, 8, 9, 100, 1000):
        assert R.merge_levels(runs) == math.ceil(math.log2(runs))


def test_exact_runs_follow_merge_region(built):
    """The natural runs and levels counted from each loaded region equal
    the kernel's merge mirror's, and the host account's run count (the
    slots) bounds them."""
    eng = built[0]
    _df, indptr, rows, _f, _p = R.workload(DOCS, VOCAB, AVG, 8, 8)
    planes = (eng.segments[0][1].post_doc.numpy(),
              eng.segments[0][1].post_val.numpy())
    seen = 0
    for _s, tabs, p in R.dispatch_calls(eng, built[2], rows, 8):
        region = F.load_region(planes, *tabs, block=p["block"],
                               r_c=p["r_c"], key_bits=p["key_bits"],
                               scale=p["scale"], clip=p["clip"])
        for words, off in region:
            if not len(words):
                continue
            qc = R.exact_counts(words, off, p["s"], p["k"], p["key_bits"])
            merged, n_runs, levels = merge_region(words.tolist(),
                                                  off.tolist())
            assert len(qc["run_off"]) - 1 == n_runs <= p["s"]
            assert R.merge_levels(n_runs) == levels
            assert qc["n"] == len(words) and qc["units"] == len(off) - 1
            assert 0 < qc["m"] <= qc["n"]
            seen += 1
    assert seen == 8


def _iterations(r, t):
    """merge_runs' co-rank loop over [0, r) when the answer is t."""
    lo, hi, it = 0, r, 0
    while lo < hi:
        mid = (lo + hi) >> 1
        lo, hi = (mid + 1, hi) if mid < t else (lo, mid)
        it += 1
    return it


def test_fewest_steps_is_the_searches_minimum():
    for r in range(0, 200):
        fewest = min(_iterations(r, t) for t in range(r + 1))
        assert R.fewest_steps(r) == fewest, r


def test_search_steps_bound_the_real_searches():
    """On random runs, each level's counted co-rank steps are at most the
    steps the merge's first searches really take (merge_region's
    partition, replayed with a counting co-rank)."""
    rng = np.random.default_rng(3)
    for threads in (4, 32, 256):
        for runs in (2, 3, 5, 8):
            lens = rng.integers(1, 60, runs)
            off = np.concatenate([[0], np.cumsum(lens)])
            n = int(off[-1])
            a = np.concatenate([np.sort(rng.integers(0, 500, ln))
                                for ln in lens])
            counted = R.search_steps(off, threads)
            assert len(counted) == R.merge_levels(runs)
            src, w, stretch = list(a), 1, -(-n // threads) | 1
            for co, _grp in counted:
                real = 0
                for t in range(threads):
                    p = t * stretch
                    if p >= n:
                        continue
                    g = max(i for i in range(0, runs, 2 * w) if off[i] <= p)
                    gs, gm = off[g], off[min(g + w, runs)]
                    ge = off[min(g + 2 * w, runs)]
                    x, y, diag = src[gs:gm], src[gm:ge], p - gs
                    lo, hi = max(0, diag - len(y)), min(diag, len(x))
                    while lo < hi:
                        mid = (lo + hi) >> 1
                        if x[mid] <= y[diag - 1 - mid]:
                            lo = mid + 1
                        else:
                            hi = mid
                        real += 1
                assert co <= real
                src = [v for grp in range(0, runs, 2 * w) for v in sorted(
                    src[off[grp]:off[min(grp + 2 * w, runs)]])]
                w *= 2


def test_radix_passes():
    k = 10
    assert R.radix_passes(np.arange(1, 11, dtype=np.int64), k) == 0
    # distinct top bytes: the first pass settles the k-th
    top = (np.arange(1, 12, dtype=np.int64) << 56)
    assert R.radix_passes(top, k) == 1
    # equal but for the last byte: every pass
    low = np.int64(1 << 40) + np.arange(1, 12, dtype=np.int64)
    assert R.radix_passes(low, k) == 8
    # the threshold keeps exactly the k largest
    comp = np.random.default_rng(1).integers(1, 1 << 40, 5000)
    assert 1 <= R.radix_passes(comp, k) <= 8


def test_placement_follows_the_kernel():
    pk = R.peaks(torch.device("cpu"))
    nb, rc = 16, 256
    words = F.buffer_words(rc, nb)
    ns = [0, words // 2, words // 2 + 1, words, words + 1, 2 * words]
    # four slots a query (four runs)
    counts = [R.host_counts(np.array([n // 4] * 3 + [n - 3 * (n // 4)]),
                            4096, R.K) for n in ns]
    acc = R.bucket_account(counts, nb, 4096, rc, R.K, pk)
    want = [F.placement(n, words) for n in ns]
    assert want == ["shared", "shared", "first", "first", "workspace",
                    "workspace"]
    assert acc["placement"] == {p: want.count(p)
                                for p in ("shared", "first", "workspace")}
    assert acc["threads"] == F.launch_threads(rc) == 1024
    # a query whose buffers lie in the workspace moves its merge through
    # device memory; one in shared memory does not
    ws = R.bucket_account([counts[-1]], nb, 4096, rc, R.K, pk)
    sh = R.bucket_account([counts[1]], nb, 4096, rc, R.K, pk)
    assert ws["stages"]["load"]["hbm"] > sh["stages"]["load"]["hbm"]
    assert sh["stages"]["merge"]["hbm"] == 0 < ws["stages"]["merge"]["hbm"]


def test_cpu_peaks_are_the_data_sheet():
    pk = R.peaks(torch.device("cpu"))
    assert (pk["sms"], pk["mhz"]) == (132, 1980)
    assert "data sheet" in pk["source"]
    assert pk["smem"] == 132 * 128 * 1980e6
    assert pk["int32"] == 132 * 64 * 1980e6
    assert (pk["hbm"], pk["f32"]) == (3.35e12, 67e12)


def test_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        R.main(env=dict(SMALL, ROOF_CARD="0"))


@pytest.mark.parametrize("min_rc", [8, 32])
def test_tiled_buckets_are_rows_of_their_own(monkeypatch, built, min_rc):
    """With the tiled threshold lowered into this size's buckets, the
    buckets that route to the tiled kernels are rows of their own
    (no B1 stages), the others keep B1's stage table, and both accounts
    still hold every real posting."""
    monkeypatch.setattr(F, "TILED_MIN_RC", min_rc)
    out = quiet(R.main, device="cpu", env=SMALL, built=built)
    natural = out["real_postings"]["natural"]
    assert out["real_postings"]["captured"] == natural
    for acc in (out["host"], out["card"]):
        assert sum(a["real_pairs"] for a in acc) == natural
        tiled = [a for a in acc if a.get("kernel") == "fused_tiled"]
        assert tiled
        for a in acc:
            assert (a["bucket"][3] >= F.TILED_MIN_RC) == (a in tiled)
            assert a["bound_ms"] > 0
            assert ("stages" in a) == (a not in tiled)
