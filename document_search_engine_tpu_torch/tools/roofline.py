"""Per-stage roofline of the fused kernel on the bench's batch.

Port of the repo-root `tools/roofline.py`, rewritten for this card's
kernel: an account of `csrc/fused_search.cu` + `csrc/rank.cuh` stage by
stage, where the original accounted the TPU's DMA and vector-unit
pipeline.

Workload, reconstructed as the original does it (pure numpy): the
bench's Zipf df table (`bench.zipf_df`) and its indptr, BENCH_NQ queries
of BENCH_TERMS_PER_QUERY rows drawn by `default_rng(7)` from the rows
with 64 <= df <= 32,768, every slot found, and the fused path's natural
plan, `ops/schedule.py plan_batch(indptr, rows, found,
families=FUSED_FAMILIES, min_blocks=4, compact=True)`.

Stages of one query (one thread block), each with the bytes and
operations it must move or do and the resource that bounds it:

  plan     warp 0 reads the 4 int32 plan tables of the launch's n_blocks
           from device memory, and writes the units' 5 int32 entries to
           shared memory.
  load     8 B a real posting (doc + value) from device memory, 2 f32
           multiplies a posting, 8 B stored a pair into buffer a.
  runs     natural_runs: two 8-byte words at each unit start (a[off - 1],
           a[off]) and the unit table; not a scan of the n pairs.
  merge    ceil(log2 runs) levels, each reading and writing 8 B a pair
           and one u64 compare a pair, plus the co-rank and group
           searches: for each active thread the fewest steps its first
           binary searches can take, floor(log2(range + 1)), two 8-byte
           reads a co-rank step and one 4-byte read a group step.
  runsums  a[i] and a[i + 1] at every position, and the steps back from
           each run end (at most s - 1).
  select   block_topk_large (every k <= 128 of the fused kernel): each
           composite written once, then the radix select's passes (at
           most 8) over them and the gather pass.
  output   k (val, doc) int32 pairs a launched query.

Buffers a and b lie where `ops/fused.py placement` (csrc/rank.cuh
place_buffers) puts them for the query's real pairs and the launch's
`buffer_words`: both in shared memory, the first only, or both in the
global workspace, whose traffic counts at the device-memory rate (it may
hit the 50 MB L2, which is faster: a workspace-bound stage's bound then
holds only for traffic that misses it). Barriers are counted, not timed:
there is no peak for them. A stage's bound is the largest of its
resources' demand over their peak; a bucket's bound is the largest of
the resources' demand over all stages (stages of different blocks
overlap on the card), and the sum of the stage bounds is printed beside
it.

Peaks: device memory 3.35 TB/s and f32 67 TFLOP/s outside the tensor
cores (the H100 SXM data sheet, chip_smoke.py's constants); shared
memory SMs x 128 B a clock and int32 SMs x 64 a clock at the SM clock.
On the card the SM count is `torch.cuda.get_device_properties` and the
clock nvidia-smi's clocks.max.sm; on the CPU the data sheet's 132 SMs
and 1,980 MHz, labelled so.

Two accounts:

- The host account, always: the natural plan's buckets, from the
  postings lengths alone. Runs are counted as the query's found slots
  (one term's postings are one ascending run; an upper bound), the
  candidates as its pairs (every doc distinct), the steps back as one a
  run end and the radix select at its 8 passes.
- The card account (ROOF_CARD=1, the default): the bench's index
  (`bench.build_synth_engine`, seed 1) serves the same rows' batch once
  through `_dispatch` (the engine row of Zipf rank r is token
  w{r:07d}'s; every slot's coefficient its bm25 idf), and each bucket of
  the captured step is counted exactly from its loaded region
  (`ops/fused.py load_region`; the natural runs' breaks a[off - 1] >
  a[off] by torch ops; the run-sums, candidates and radix passes from
  the sorted pairs) and, on the card, timed: the median of 5 launches
  of `fused_search` with CUDA events after one warm launch. The captured
  buckets are the engine's layout cells (ops/plan_cache.py), which pad
  bq and n_blocks, not the natural buckets, so the two accounts are
  compared by their total real postings only: padding rows and skipped
  blocks read none.

The buckets that `fused_search` serves by the tiled kernels
(`ops/tiled.py tiled_route`: r_c >= TILED_MIN_RC and a tile block that
fits; csrc/fused_tiled.cu)
have none of these stages: each is one row of its own (kernel
"fused_tiled"), timed whole, with the demand of its real pairs: 8 B a
pair from device memory (doc and value), the plan tables, the chunks'
survivors written and read and the output; one 8-byte shared-memory
atomic a pair (its accumulator read and written); one int32 add and two
f32 multiplies a pair. The per-stage table describes only the buckets
that the fused kernel (B1) still runs.

Gates (AssertionError): the natural plan's real postings equal the
captured buckets' sum; no bucket on the card measures below its bound
(such a reading means a count is wrong).

    python -m document_search_engine_tpu_torch.tools.roofline
    BENCH_DOCS=3000 BENCH_VOCAB=2000 BENCH_NQ=64 python -m \\
        document_search_engine_tpu_torch.tools.roofline --device cpu

Env: BENCH_DOCS (1,000,000), BENCH_VOCAB (200,000), BENCH_AVG_TERMS (60),
BENCH_NQ (8192), BENCH_TERMS_PER_QUERY (8), ROOF_CARD (1). k is 10.
"""
from __future__ import annotations

import math
import os
import subprocess
import time

import numpy as np
import torch

from .. import bench as B
from ..config import IndexConfig, ScoringConfig
from ..ops import fused as F
from ..ops import tiled as T
from ..ops.plan_cache import PlanLayoutCache
from ..ops.schedule import FUSED_FAMILIES, plan_batch

K = 10
TIMED_REPS = 5
# the H100 SXM data sheet (chip_smoke.py's HBM_BYTES_PER_S, F32_FLOPS)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
DATASHEET_SMS, DATASHEET_MHZ = 132, 1980
SMEM_BYTES_PER_CLOCK, INT32_PER_CLOCK = 128, 64  # a clock and SM
STAGES = ("plan", "load", "runs", "merge", "runsums", "select", "output")
RESOURCES = ("hbm", "smem", "int32", "f32")
MASK32 = 0xFFFFFFFF
# the counts of a query with no real pair (a padding row)
EMPTY = {"n": 0, "units": 0, "run_off": np.zeros(1, np.int64), "m": 0,
         "walk": 0, "passes": 0}


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------- peaks
def peaks(dev) -> dict:
    """The card's peaks a second, by resource, and where they come
    from."""
    if dev.type == "cuda":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True)
        mhz = float(out.stdout.split()[0])
        source = (f"{sms} SMs (torch.cuda.get_device_properties), "
                  f"{mhz:.0f} MHz (nvidia-smi clocks.max.sm)")
    else:
        sms, mhz = DATASHEET_SMS, DATASHEET_MHZ
        source = (f"{sms} SMs, {mhz} MHz: the H100 SXM data sheet (no card "
                  "read)")
    clk = mhz * 1e6
    return {
        "hbm": HBM_BYTES_PER_S, "smem": sms * SMEM_BYTES_PER_CLOCK * clk,
        "int32": sms * INT32_PER_CLOCK * clk, "f32": F32_FLOPS,
        "sms": sms, "mhz": mhz, "source": source,
    }


# ----------------------------------------------------------- workload
def workload(n_docs, vocab, avg_terms, nq, tpq):
    """The bench's batch as the original reconstructs it: (df by Zipf
    rank, indptr, rows (nq, tpq), found, the natural plan [(idx,
    n_blocks, block, r_c)])."""
    df = B.zipf_df(n_docs, vocab, avg_terms)
    indptr64 = np.zeros(vocab + 1, np.int64)
    np.cumsum(df.astype(np.int64), out=indptr64[1:])
    indptr = indptr64.astype(np.int32)
    rng = np.random.default_rng(7)
    eligible = np.where((df >= 64) & (df <= 32768))[0]
    rows = rng.choice(eligible, size=(nq, tpq))
    found = np.ones((nq, tpq), bool)
    plans = plan_batch(indptr, rows, found, families=FUSED_FAMILIES,
                       min_blocks=4, compact=True)
    return df, indptr, rows, found, plans


# ---------------------------------------------------- per-query counts
def merge_levels(runs: int) -> int:
    """csrc/rank.cuh merge_runs' levels for `runs` natural runs."""
    return 0 if runs <= 1 else math.ceil(math.log2(runs))


def fewest_steps(rng):
    """The fewest iterations of merge_runs' binary searches over a range
    of `rng` candidates: each step leaves ceil(rng / 2) - 1 at best."""
    return np.floor(np.log2(np.asarray(rng, np.float64) + 1)).astype(
        np.int64)


def search_steps(run_off: np.ndarray, threads: int) -> list:
    """Per merge level: (co-rank steps, group-search steps) summed over
    the active threads, at the fewest each thread's first searches take
    (a thread whose stretch crosses into the next group searches it at
    diagonal 0, in no step)."""
    runs = len(run_off) - 1
    n = int(run_off[-1])
    out = []
    if runs <= 1:
        return out
    stretch = -(-n // threads) | 1
    p = np.arange(threads, dtype=np.int64) * stretch
    p = p[p < n]
    w = 1
    while w < runs:
        gi = np.searchsorted(run_off[0:runs:2 * w], p, side="right") - 1
        g = gi * 2 * w
        gs = run_off[g]
        gm = run_off[np.minimum(g + w, runs)]
        ge = run_off[np.minimum(g + 2 * w, runs)]
        diag = p - gs
        rng = np.minimum(diag, gm - gs) - np.maximum(0, diag - (ge - gm))
        out.append((int(fewest_steps(rng).sum()),
                    int(fewest_steps((runs - 1) // (2 * w))) * len(p)))
        w *= 2
    return out


def radix_passes(comp: np.ndarray, k: int) -> int:
    """The passes block_topk_large's radix select makes over the
    composites (int64, all > 0): none for at most k, else 8 bits a pass
    from the top until every match of the chosen bin is wanted."""
    if len(comp) <= k:
        return 0
    prefix, need, passes = 0, k, 0
    for shift in range(56, -1, -8):
        passes += 1
        fixed = 0 if shift == 56 else (-1 << (shift + 8))
        match = comp[(comp & np.int64(fixed)) == np.int64(prefix)]
        hist = np.bincount((match >> shift) & 255, minlength=256)
        upto = np.cumsum(hist[::-1])[::-1]  # matches in bins >= d
        d = int(np.nonzero(upto >= need)[0][-1])
        above = int(upto[d] - hist[d])
        prefix |= d << shift
        if need - above == hist[d]:
            break
        need -= above
    return passes


def host_counts(lens: np.ndarray, block: int, k: int) -> dict:
    """A query's counts from its slots' postings lengths (the host
    account's model: one run a slot, every doc distinct, 8 passes)."""
    live = lens[lens > 0].astype(np.int64)
    n = int(live.sum())
    return {
        "n": n, "units": int((-(-live // block)).sum()),
        "run_off": np.concatenate([[0], np.cumsum(live)]),
        "m": n, "walk": max(n - 1, 0), "passes": 8 if n > k else 0,
    }


def exact_counts(words: np.ndarray, off: np.ndarray, s: int, k: int,
                 kb: int) -> dict:
    """A query's counts from its loaded region (load_region: the (n,)
    int64 words (key << 32) | ci, each unit behind the previous one, and
    the unit offsets)."""
    n = len(words)
    if n == 0:
        return EMPTY
    w = torch.from_numpy(words)
    o = torch.from_numpy(off[:-1].astype(np.int64))
    start = torch.ones(len(o), dtype=torch.bool)
    start[1:] = w[o[1:] - 1] > w[o[1:]]
    run_off = np.append(o[start].numpy(), n)
    a = np.sort(words)
    doc = (a >> 32) >> kb
    ends = np.append(np.nonzero(doc[1:] != doc[:-1])[0], n - 1)
    cnt = np.diff(np.concatenate([[-1], ends]))
    cs = np.concatenate([[0], np.cumsum(a & MASK32)])
    win = np.minimum(cnt, s)
    run = cs[ends + 1] - cs[ends + 1 - win]
    walk = (np.minimum(cnt - 1, s - 1).sum()
            + ((cnt < s) & (ends - cnt + 1 > 0)).sum())
    comp = (run[run > 0] << 32) | (0x7FFFFFFF - doc[ends][run > 0])
    return {"n": n, "units": len(off) - 1, "run_off": run_off,
            "m": len(comp), "walk": int(walk),
            "passes": radix_passes(comp, k)}


# ------------------------------------------------------------- demand
def query_demand(qc: dict, n_blocks: int, k: int, threads: int,
                 words: int, dem: dict) -> int:
    """Adds one query's demand, by stage and resource, into `dem`;
    returns its barriers."""
    n, units, m = qc["n"], qc["units"], qc["m"]
    runs = len(qc["run_off"]) - 1
    place = F.placement(n, words)
    space_a = "smem" if place != "workspace" else "hbm"
    space_b = "smem" if place == "shared" else "hbm"

    def add(stage, res, v):
        dem[stage][res] += v

    add("plan", "hbm", 16 * n_blocks)
    add("plan", "smem", 20 * units + 8)
    add("load", "hbm", 8 * n)
    add("load", "f32", 2 * n)
    add("load", space_a, 8 * n)
    add("runs", space_a, 8 * max(2 * units - 1, 0))
    add("runs", "smem", 8 * units + 4 * (runs + 1))
    levels = search_steps(qc["run_off"], threads)
    spaces = (space_a, space_b)
    for lev, (co, grp) in enumerate(levels):
        src, dst = spaces[lev % 2], spaces[1 - lev % 2]
        add("merge", src, 8 * n + 16 * co)
        add("merge", dst, 8 * n)
        add("merge", "smem", 4 * grp)
        add("merge", "int32", 2 * n + 2 * co)
    sorted_in = spaces[len(levels) % 2]
    comp_in = spaces[1 - len(levels) % 2]
    add("runsums", sorted_in, 8 * (max(2 * n - 1, 0) + qc["walk"]))
    add("runsums", "int32", 2 * n + 2 * qc["walk"])
    add("select", comp_in, 8 * m * (2 + qc["passes"]))
    add("select", "int32", 2 * m * qc["passes"])
    add("output", "hbm", 8 * k)
    return 6 + len(levels) + 3 * qc["passes"]


def bucket_account(counts: list, n_blocks: int, block: int, r_c: int,
                   k: int, pk: dict, bq: int | None = None) -> dict:
    """The stages' demand and bounds of one bucket of queries (counts:
    one dict a real query; bq: the launched queries, padding rows
    included, default len(counts))."""
    bq = len(counts) if bq is None else bq
    threads = F.launch_threads(r_c)
    words = F.buffer_words(r_c, n_blocks)
    dem = {st: dict.fromkeys(RESOURCES, 0) for st in STAGES}
    barriers = [query_demand(qc, n_blocks, k, threads, words, dem)
                for qc in counts]
    barriers += [query_demand(EMPTY, n_blocks, k, threads, words, dem)
                 for _ in range(bq - len(counts))]
    stages = {}
    for st in STAGES:
        t = {res: dem[st][res] / pk[res] * 1e3 for res in RESOURCES}
        by = max(t, key=t.get)
        stages[st] = {**{res: int(dem[st][res]) for res in RESOURCES},
                      "ms": t[by], "by": by}
    tot = {res: sum(dem[st][res] for st in STAGES) / pk[res] * 1e3
           for res in RESOURCES}
    bound_by = max(tot, key=tot.get)
    places = [F.placement(qc["n"], words) for qc in counts]
    runs = [len(qc["run_off"]) - 1 for qc in counts]
    return {
        "bucket": [bq, n_blocks, block, r_c], "threads": threads,
        "placement": {p: places.count(p)
                      for p in ("shared", "first", "workspace")},
        "real_pairs": sum(qc["n"] for qc in counts),
        "runs_max": max(runs, default=0),
        "levels_max": merge_levels(max(runs, default=0)),
        "barriers": sum(barriers), "barriers_max": max(barriers, default=0),
        "stages": stages,
        "stage_sum_ms": sum(s["ms"] for s in stages.values()),
        "bound_ms": tot[bound_by], "bound_by": bound_by,
        "dominant": max(stages, key=lambda st: stages[st]["ms"]),
    }


def tiled_account(pairs: int, bq: int, n_blocks: int, block: int,
                  r_c: int, s: int, n_docs: int, k: int, pk: dict) -> dict:
    """One bucket that the tiled kernels serve, whole: the demand of its
    real pairs, plan tables, survivors and output, and its bound."""
    chunks = T.tiled_chunks(n_docs)
    dem = {"hbm": 8 * pairs + 16 * n_blocks * bq + 16 * k * chunks * bq
           + 8 * k * bq,
           "smem": 8 * pairs, "int32": pairs, "f32": 2 * pairs}
    t = {res: dem[res] / pk[res] * 1e3 for res in RESOURCES}
    by = max(t, key=t.get)
    return {"bucket": [bq, n_blocks, block, r_c], "kernel": "fused_tiled",
            "threads": T.TILED_THREADS, "s": s, "chunks": chunks,
            "real_pairs": pairs, "demand": dem, "bound_ms": t[by],
            "bound_by": by}


def host_account(indptr, rows, plans, k, pk, n_docs) -> list:
    """The natural plan's buckets, from the postings lengths alone."""
    lens = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
    out = []
    for idx, n_blocks, block, r_c in plans:
        if T.tiled_route(mode="fused", k=k, split=False, r_c=r_c,
                         n_blocks=n_blocks, s=rows.shape[1]):
            out.append(tiled_account(int(lens[idx].sum()), len(idx),
                                     n_blocks, block, r_c, rows.shape[1],
                                     n_docs, k, pk))
        else:
            out.append(bucket_account(
                [host_counts(lens[q], block, k) for q in idx], n_blocks,
                block, r_c, k, pk))
    return out


# --------------------------------------------------------- card account
def bucket_calls(step, inputs, dev) -> list:
    """Per bucket of one dispatched fused step (eng._last_step): (segment,
    plan tables, the kernel's keyword arguments)."""
    rows_cat, cbits_cat = (torch.from_numpy(a).to(dev) for a in inputs[:2])
    kw = step.keywords
    calls, off = [], 0
    for (n_docs, _base, seg), (_nd, s, buckets) in zip(step.args[0],
                                                       kw["plan"]):
        for n_blocks, block, bq, r_c in buckets:
            tabs = F.expand_plan_tables(
                seg.row_start, seg.indptr, rows_cat[off : off + bq],
                cbits_cat[off : off + bq], n_blocks, block)
            off += bq
            calls.append((seg, tabs, dict(
                n_blocks=n_blocks, block=block, s=s, k=kw["k"],
                n_docs=n_docs, scale=kw["scale"], clip=kw["clip"], r_c=r_c,
                key_bits=F.key_bits_for(s, n_docs))))
    if not calls:
        raise AssertionError("roofline: the dispatched step has no bucket")
    return calls


def engine_batch(eng, tokens_by_row, rows, tpq):
    """The pre-analyzed batch of the Zipf-rank rows on the engine: (slot
    hashes, coefficients, engine rows, found), one slot a drawn row
    (duplicates kept, as the original plans them), bm25 idf
    coefficients."""
    rank_to_row = np.empty(len(tokens_by_row), np.int64)
    rank_to_row[[int(t[1:]) for t in tokens_by_row]] = np.arange(
        len(tokens_by_row))
    erows = rank_to_row[rows]
    nq, s_full = len(rows), eng.config.max_query_terms
    slot_h = np.zeros((nq, s_full), np.uint64)
    coeff = np.zeros((nq, s_full), np.float32)
    rows_g = np.zeros((nq, s_full), np.int32)
    found_g = np.zeros((nq, s_full), bool)
    slot_h[:, :tpq] = eng.stats.vocab[erows]
    coeff[:, :tpq] = eng.stats.idf_by_row(eng.config.scoring.kind)[erows]
    rows_g[:, :tpq] = erows
    found_g[:, :tpq] = True
    return slot_h, coeff, rows_g, found_g


def dispatch_calls(eng, tokens_by_row, rows, tpq) -> list:
    """The batch once through the engine's fused path (fresh plan
    layouts, the default families and planner, no split), and its
    buckets' kernel calls; the engine's fields are put back."""
    saved = (eng.scorer, eng.split_rows, eng.block_families,
             eng.plan_min_blocks, eng.plan_cache)
    try:
        eng.scorer, eng.split_rows, eng.block_families = "fused", None, None
        eng.plan_min_blocks, eng.plan_cache = 4, PlanLayoutCache()
        eng._collect(eng._dispatch(
            engine_batch(eng, tokens_by_row, rows, tpq), K))
        step, inputs = eng._last_step
        return bucket_calls(step, inputs, eng.device)
    finally:
        (eng.scorer, eng.split_rows, eng.block_families,
         eng.plan_min_blocks, eng.plan_cache) = saved


def time_call(seg, tabs, p) -> float:
    """Median ms of TIMED_REPS launches (CUDA events) after a warm one."""
    def run():
        return F.fused_search(seg.post_doc, seg.post_val, *tabs, **p)

    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_REPS):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        run()
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    return float(np.median(times))


def card_account(calls, k, pk, dev) -> list:
    """Each captured bucket counted exactly (a tiled one from its plan
    tables' runs, B1's from its loaded region) and, on the card, timed;
    raises if a bucket measures below its bound."""
    planes_h = {}
    out = []
    for seg, tabs, p in calls:
        if T.tiled_route(mode="fused", k=p["k"], split=False, r_c=p["r_c"],
                         n_blocks=p["n_blocks"], s=p["s"]):
            runs = T.tiled_runs(*(t.cpu().numpy() for t in tabs),
                                block=p["block"], r_c=p["r_c"])
            acc = tiled_account(
                sum(int(r["off"][-1]) for r in runs), int(tabs[0].shape[0]),
                p["n_blocks"], p["block"], p["r_c"], p["s"], p["n_docs"], k,
                pk)
            acc["ms"] = acc["blocks_per_sm"] = None
            if dev.type == "cuda":
                acc["ms"] = time_call(seg, tabs, p)
                acc["blocks_per_sm"] = T.tiled_blocks_per_sm(p["n_blocks"],
                                                             p["s"])
                if acc["ms"] < acc["bound_ms"]:
                    raise AssertionError(
                        f"roofline: tiled bucket {acc['bucket']} measures "
                        f"{acc['ms']:.4f} ms, below its bound "
                        f"{acc['bound_ms']:.4f} ms: a count is wrong")
            out.append(acc)
            continue
        key = id(seg)
        if key not in planes_h:
            planes_h[key] = (seg.post_doc.cpu().numpy(),
                             seg.post_val.cpu().numpy())
        region = F.load_region(
            planes_h[key], *(t.cpu().numpy() for t in tabs),
            block=p["block"], r_c=p["r_c"], key_bits=p["key_bits"],
            scale=p["scale"], clip=p["clip"])
        counts = [exact_counts(w, o, p["s"], k, p["key_bits"])
                  for w, o in region]
        real = [qc for qc in counts if qc["n"]]
        acc = bucket_account(real, p["n_blocks"], p["block"], p["r_c"], k,
                             pk, bq=len(counts))
        acc["ms"] = acc["blocks_per_sm"] = None
        if dev.type == "cuda":
            acc["ms"] = time_call(seg, tabs, p)
            acc["blocks_per_sm"] = F._lib().dse_fused_blocks_per_sm(
                0, acc["threads"], p["r_c"], p["n_blocks"])
            if acc["ms"] < acc["bound_ms"]:
                raise AssertionError(
                    f"roofline: bucket {acc['bucket']} measures "
                    f"{acc['ms']:.4f} ms, below its bound "
                    f"{acc['bound_ms']:.4f} ms: a count is wrong")
        out.append(acc)
    return out


# ---------------------------------------------------------------- print
def print_buckets(title, accs) -> None:
    """B1's buckets stage by stage, then the tiled kernels' buckets, each
    whole."""
    tiled = [a for a in accs if a.get("kernel") == "fused_tiled"]
    accs = [a for a in accs if a.get("kernel") != "fused_tiled"]
    log(title)
    log(f"{'bucket [bq, nb, block, r_c]':>28} {'thr':>5} {'b/SM':>4} "
        f"{'place s/f/w':>13} {'pairs':>10} {'runs':>4} {'bar':>8} "
        + " ".join(f"{st:>8}" for st in STAGES)
        + f" {'sum':>8} {'bound':>8} {'by':>5} {'ms':>8} {'ms/bnd':>7} "
        f"{'ms/sum':>7} {'dominant':>8}")
    for a in accs:
        pl = a["placement"]
        ms = "n/a" if a.get("ms") is None else f"{a['ms']:.4f}"
        ratio = ("" if a.get("ms") is None
                 else f"{a['ms'] / a['bound_ms']:.1f}")
        ratio_sum = ("" if a.get("ms") is None
                     else f"{a['ms'] / a['stage_sum_ms']:.1f}")
        log(f"{str(a['bucket']):>28} {a['threads']:>5} "
            f"{str(a.get('blocks_per_sm', '')):>4} "
            f"{pl['shared']:>4}/{pl['first']}/{pl['workspace']:<4} "
            f"{a['real_pairs']:>10} {a['runs_max']:>4} {a['barriers']:>8} "
            + " ".join(f"{a['stages'][st]['ms']:8.4f}" for st in STAGES)
            + f" {a['stage_sum_ms']:8.4f} {a['bound_ms']:8.4f} "
            f"{a['bound_by']:>5} {ms:>8} {ratio:>7} {ratio_sum:>7} "
            f"{a['dominant']:>8}")
    if not tiled:
        return
    log("  tiled kernels (csrc/fused_tiled.cu), each bucket whole:")
    log(f"{'bucket [bq, nb, block, r_c]':>28} {'thr':>5} {'b/SM':>4} "
        f"{'chunks':>6} {'pairs':>10} {'bound':>8} {'by':>5} {'ms':>8} "
        f"{'ms/bnd':>7}")
    for a in tiled:
        ms = "n/a" if a.get("ms") is None else f"{a['ms']:.4f}"
        ratio = ("" if a.get("ms") is None
                 else f"{a['ms'] / a['bound_ms']:.1f}")
        log(f"{str(a['bucket']):>28} {a['threads']:>5} "
            f"{str(a.get('blocks_per_sm', '')):>4} {a['chunks']:>6} "
            f"{a['real_pairs']:>10} {a['bound_ms']:8.4f} {a['bound_by']:>5} "
            f"{ms:>8} {ratio:>7}")


def main(device=None, env=None, built=None) -> dict:
    """The roofline at the BENCH_* knobs of `env` (default: the
    process's environment) on `device` (None: the card). `built` is the
    bench index as (engine, df_by_row, tokens_by_row) at the same knobs,
    made here when None and ROOF_CARD is 1. Returns the peaks, the
    workload, the host account (one dict a natural bucket), the card
    account (one a captured bucket; None with ROOF_CARD=0) and the real
    postings of each."""
    env = os.environ if env is None else env
    dev = B.resolve_device(device, "roofline")
    n_docs = int(env.get("BENCH_DOCS", 1_000_000))
    vocab = int(env.get("BENCH_VOCAB", 200_000))
    avg_terms = int(env.get("BENCH_AVG_TERMS", 60))
    nq = int(env.get("BENCH_NQ", 8192))
    tpq = int(env.get("BENCH_TERMS_PER_QUERY", 8))
    card_mode = env.get("ROOF_CARD", "1") == "1"

    pk = peaks(dev)
    log(f"platform: {B.card_line(dev)}")
    log(f"peaks: device memory {pk['hbm'] / 1e12:.2f} TB/s, shared memory "
        f"{pk['smem'] / 1e12:.2f} TB/s, int32 {pk['int32'] / 1e12:.2f} "
        f"Top/s, f32 {pk['f32'] / 1e12:.0f} TFLOP/s ({pk['source']}; "
        "3.35 TB/s and 67 TFLOP/s: the H100 SXM data sheet)")
    t0 = time.perf_counter()
    df, indptr, rows, _found, plans = workload(n_docs, vocab, avg_terms, nq,
                                               tpq)
    lens = (indptr[rows + 1] - indptr[rows]).astype(np.int64).sum(1)
    log(f"workload: nq={nq} tpq={tpq} vocab={vocab} docs={n_docs}")
    log(f"postings/query: mean {lens.mean():,.0f}  p50 "
        f"{np.median(lens):,.0f}  max {lens.max():,}")
    host = host_account(indptr, rows, plans, K, pk, n_docs)
    natural = int(lens.sum())
    print_buckets(f"host account, natural plan ({len(plans)} buckets; "
                  f"{time.perf_counter() - t0:.1f}s):", host)
    out = {"peaks": pk, "nq": nq, "natural_buckets": [
        [len(idx), nb, blk, rc] for idx, nb, blk, rc in plans],
        "host": host, "card": None, "real_postings": {"natural": natural}}
    if not card_mode:
        return out

    if built is None:
        cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
        built = B.build_synth_engine(n_docs, vocab, avg_terms, cfg, seed=1,
                                     device=dev)
    eng, df_by_row, tokens_by_row = built
    if not np.array_equal(np.sort(df_by_row), np.sort(df)):
        raise AssertionError("roofline: the index's df is not the workload's")
    t0 = time.perf_counter()
    calls = dispatch_calls(eng, tokens_by_row, rows, tpq)
    card = card_account(calls, K, pk, dev)
    captured = sum(a["real_pairs"] for a in card)
    out["card"] = card
    out["real_postings"]["captured"] = captured
    print_buckets(f"card account, the engine's cells ({len(card)} buckets; "
                  f"{time.perf_counter() - t0:.1f}s; ms: median of "
                  f"{TIMED_REPS} launches):", card)
    if captured != natural:
        raise AssertionError(f"roofline: the captured buckets hold {captured} "
                             f"real postings, the natural plan {natural}")
    if dev.type == "cuda":
        ms = sum(a["ms"] for a in card)
        bound = sum(a["bound_ms"] for a in card)
        log(f"card: {ms:.4f} ms over {len(card)} buckets against "
            f"{bound:.4f} ms of bounds ({ms / bound:.1f}x)")
    log(f"real postings: natural plan {natural:,}, captured buckets "
        f"{captured:,} (equal)")
    return out


if __name__ == "__main__":
    from . import device_arg

    main(device_arg("document_search_engine_tpu_torch.tools.roofline"))
