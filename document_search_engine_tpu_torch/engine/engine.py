"""SearchEngine over torch device segments: build -> search_stream, and
the serving path both engines share.

Port of `document_search_engine_tpu/engine/engine.py`: build,
add_docs, the streaming build, delete_docs, compact and the auto-compact
policy, the stats and value refresh, save/load (index/checkpoint.py),
search, search_stream, preplan and warmup, with the batch step
(`_batch_step`) running every (segment x bucket) sub-call of a batch and
producing one stacked int32 output, so a batch costs one device->host
read. Over several segments the step also merges each query's ranked
lists across them (ops/segment_merge.py) where the batch has no
doc-range pieces and k <= 128 (`_device_merges`), so that the read is the
answer; elsewhere `_collect` merges them on the host. On the card the
step is the JAX package's jitted program's counterpart: one CUDA graph
per plan-layout key (engine/step_graph.py), captured on a key's first
batch and replayed for every later one, its inputs copied from pinned
memory without waiting on the card.

The serving path is written once, here, for SearchEngine and
parallel/dist.py's DistributedSearchEngine: `ServingEngine` holds the
scorer mode, the request check, search, search_stream with its
re-analysis rule, search_rerank, warmup and preplan's loop;
`fill_buckets` the host bucket fill, `merge_pieces` and `_merge_ranked`
the host merge, and `route_bucket` the per-bucket device route (plan
expansion, doc limits, the scorer by (mode, k), the gid mask) that both
batch steps call. Each engine keeps its planning, `_dispatch` and
`_collect`.

Also the hybrid rerank path: `search_rerank` and its device-resident
embedding table (`_device_embeddings`, ops/rerank.py).

The engine runs on the card unless the caller asks for the CPU
(`device="cpu"`, as the tests do). Scorer modes, the reference's four:
"fused" (the hand-written CUDA kernel, ops/fused.py; the default on
CUDA), "fused_dv" (the same kernel reading one interleaved doc|value
plane per segment, ops/fused_dv.py), "xla" (the plain PyTorch scorer,
ops/packed.py; the default on the CPU; "plain" is its alias) and
"xla_rank" (the plain pack, then the rank-only CUDA kernel, ops/rank.py).
On CPU tensors every kernel wrapper takes its plain version. All modes
give the same ids and integer scores. As in the reference, the kernels
serve k <= 128 and larger k takes the plain scorer over uncompacted
plans, by k alone ("fused_dv" is downgraded to "fused" first).

Doc-range splitting (`split_rows`, the fused mode with one block
family): queries needing more compacted candidate rows than the
threshold are cut into doc-disjoint pieces (ops/schedule.py
split_pieces), each ranked by the fused kernel with per-piece doc limits
and merged per query by (score desc, gid asc) on the host.

Every mutation (add, delete, compact, streaming build, load) re-merges
the global stats and drops every per-segment device cache (row tables,
embeddings, dv planes, doc-quantile tables) and every step graph, so no
cache keeps a replaced plane resident.

The phase timers, the serving path's spans and the step counters, and
where each opens, are listed once, in utils/prof.py's docstring.
"""
from __future__ import annotations

from contextlib import nullcontext
from functools import partial

import numpy as np
import torch

from ..config import IndexConfig
from ..index import builder
from ..index.csr import GlobalStats, merge_stats, ragged_positions
from ..ops.fused import MAX_K
from ..ops.plan_cache import PlanLayoutCache
from ..ops.schedule import (
    DEFAULT_FAMILIES,
    FUSED_FAMILIES,
    plan_batch,
    split_pieces,
)
from ..ops.tiled import tiled_route
from ..oracle import spec
from ..utils import prof
from .query import QueryFrontend, segment_rows
from .step_graph import (
    StepGraphs,
    dispatch_span,
    resident_key,
    run_step,
    step_key,
)

F32 = np.float32
SCORER_ALIASES = {"plain": "xla"}


def _pow2_at_least(n: int, lo: int = 1) -> int:
    n = max(n, lo)
    return 1 << int(np.ceil(np.log2(n)))


def route_bucket(
    planes,  # (post_doc, post_val, row_start, indptr) of a segment or shard
    rows_cat: torch.Tensor,  # (B, S) i32 term rows of the batch's buckets
    cbits_cat: torch.Tensor,  # (B, S) i32 coefficient bits
    cols_cat,  # (B, 2) i32 piece columns, or None (no split)
    off: int,  # the bucket's first row in the *_cat tensors
    bucket,  # (n_blocks, block, bq, r_c)
    *,
    s: int,
    k: int,
    mode: str,  # "fused" | "fused_dv" | "xla" | "xla_rank"
    scale: float,
    clip: float,
    sentinel: int,  # the scorers' local doc sentinel
    doc_base: int,
    split=None,  # (offs_dev, n_docs, P): doc-range pieces, or None
    dv_plane=None,  # the (X+8, 256) dv plane ("fused_dv")
):
    """One bucket's device work, the route both batch steps take: the
    plan tables expand from the bucket's (bq, S) rows and coefficient
    bits, a piece's doc limits apply, the scorer is picked by (mode, k)
    and the gid mask where(v > 0, dloc + doc_base, -1) applies. Returns
    the bucket's (vals, gids), (bq, k) int32. It reads no tensor's value
    on the host, so a step of such calls captures into a CUDA graph.

    With split, plan rows are doc-range pieces: their record ranges come
    from the resident quantile table offs_dev and the kernel limits each
    piece to local docs [cols[0] * n_docs // P, cols[1] * n_docs // P).
    The key bits are key_bits_for(s, sentinel)."""
    from ..ops.fused import expand_plan_tables, fused_search, key_bits_for
    from ..ops.fused_dv import fused_search_dv
    from ..ops.packed import pack_tables, search_packed_tables
    from ..ops.rank import rank_candidates_kernel

    post_doc, post_val, row_start, indptr = planes
    n_blocks, block, bq, r_c = bucket
    cols_b = dlim = offs_dev = None
    if split is not None:
        offs_dev, n_docs, p = split
        cols_b = cols_cat[off : off + bq]
        dlim = ((cols_b.long() * n_docs) // p).to(torch.int32).reshape(
            bq, 1, 2)
    sr, rm, ab, dst = expand_plan_tables(
        row_start, indptr, rows_cat[off : off + bq],
        cbits_cat[off : off + bq], n_blocks, block, offs_dev=offs_dev,
        cols=cols_b,
    )
    # the kernels serve k <= MAX_K (128); larger k takes the plain
    # scorer, as the reference takes its XLA twin: by k alone
    if mode in ("fused", "fused_dv") and k <= MAX_K:
        kw = dict(
            n_blocks=n_blocks, block=block, s=s, k=k, n_docs=sentinel,
            scale=scale, clip=clip, r_c=r_c,
            key_bits=key_bits_for(s, sentinel),
        )
        if mode == "fused_dv":
            v, dloc = fused_search_dv(dv_plane, sr, rm, ab, dst, **kw)
        else:
            v, dloc = fused_search(
                post_doc, post_val, sr, rm, ab, dst, dlim=dlim, **kw
            )
        return v, torch.where(v > 0, dloc + doc_base, torch.full_like(v, -1))
    if mode == "xla_rank" and k <= MAX_K:
        # the plain pack, then the rank-only kernel
        d_key, ci = pack_tables(
            post_doc, post_val, sr, rm, ab, scale, clip, n_blocks, block,
            sentinel, dlim=dlim,
        )
        return rank_candidates_kernel(
            d_key, ci, doc_base, block=block, s=s, k=k, n_docs=sentinel
        )
    return search_packed_tables(
        post_doc, post_val, sr, rm, ab, scale, clip, doc_base,
        n_blocks=n_blocks, block=block, s=s, k=k, n_docs=sentinel, dlim=dlim,
    )


def _batch_step(
    segments,  # list of (n_docs, doc_base, SegmentDevice)
    rows_cat: torch.Tensor,  # (sum of bucket bq + tail, S) i32 term rows
    cbits_cat: torch.Tensor,  # (sum of bucket bq, S) i32 coefficient bits
    cols_cat=None,  # (sum of bucket bq, 2) i32 piece columns (split)
    *,
    plan,  # per segment (n_docs, s, ((n_blocks, block, bq, r_c), ...))
    k: int,
    scale: float,
    clip: float,
    mode: str,  # "fused" | "fused_dv" | "xla" | "xla_rank"
    n_real: int,  # readback rows: the gather's size, or nq when merged
    dv_planes=None,  # per segment (X+8, 256) dv plane ("fused_dv")
    offs_devs=None,  # per segment (T, P+1) i32 doc-quantile tables
    split_p: int = 0,  # quantile columns P (0 = splitting off)
    merge: bool = False,  # merge the segments' lists (_device_merges)
):
    """The device work of one batch: route_bucket per (segment x
    bucket), each segment's n_docs its sentinel. Returns ONE (n_real,
    2k) int32 tensor — per-bucket [vals | gids] stacked in plan order,
    with the pow-2 bq padding rows dropped by a gather whose indices ride
    in rows_cat's tail (the same host->device copy). With merge, the tail
    holds instead the (n_real = nq, S) table of each query's stacked row
    in each segment (-1: none), and the output is each query's answer,
    merged across the segments by ops/segment_merge.py. It captures into
    a CUDA graph whole."""
    from ..ops.segment_merge import segment_merge

    out_v, out_g = [], []
    off = 0
    for si, ((n_docs, doc_base, dev_seg), (_nd, s, buckets)) in enumerate(
        zip(segments, plan)
    ):
        planes = (dev_seg.post_doc, dev_seg.post_val, dev_seg.row_start,
                  dev_seg.indptr)
        split = (offs_devs[si], n_docs, split_p) if split_p else None
        for bucket in buckets:
            v, g = route_bucket(
                planes, rows_cat, cbits_cat, cols_cat, off, bucket, s=s,
                k=k, mode=mode, scale=scale, clip=clip, sentinel=n_docs,
                doc_base=doc_base, split=split,
                dv_plane=dv_planes[si] if dv_planes else None,
            )
            off += bucket[2]
            out_v.append(v)
            out_g.append(g)
    stacked = torch.cat([torch.cat(out_v, 0), torch.cat(out_g, 0)], 1)
    width = len(segments) if merge else 1
    n_tail = n_real * width
    n_extra = -(-n_tail // rows_cat.shape[1])
    tail = rows_cat[off : off + n_extra].reshape(-1)[:n_tail]
    if merge:
        return segment_merge(stacked, tail.reshape(n_real, width), k)
    return stacked.index_select(0, tail.long())


def pipelined_stream(query_batches, depth, analyze_job, dispatch_job, span):
    """Serving loop: a worker thread prefetches analysis up to 2 batches
    ahead while the main thread dispatches and drains a depth-N
    in-flight window. analyze_job(queries) -> analysis snapshot or None
    (safe on a worker thread); dispatch_job(queries, analysis) -> a thunk
    producing that batch's (ids, scores) when called; span(name) -> the
    context the main thread waits for an analysis in (a phase timer,
    step_graph.py dispatch_span)."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    inflight: deque = deque()  # thunks producing (ids, scores)
    an_q: deque = deque()  # (queries, analysis future)
    it = iter(query_batches)
    with ThreadPoolExecutor(max_workers=1) as pool:

        def submit_next() -> bool:
            try:
                queries = next(it)
            except StopIteration:
                return False
            if not isinstance(queries, (list, tuple)):
                queries = list(queries)
            an_q.append((queries, pool.submit(analyze_job, queries)))
            return True

        for _ in range(2):  # analysis lookahead window
            if not submit_next():
                break
        while an_q:
            queries, fut_an = an_q.popleft()
            with span("stream.wait_analysis"):
                res = fut_an.result()
            submit_next()
            inflight.append(dispatch_job(queries, res))
            if len(inflight) >= depth:
                yield inflight.popleft()()
        while inflight:
            yield inflight.popleft()()


def delete_from_hosts(hosts, global_ids) -> bool:
    """Vectorized tombstone and exact df decrement over a list of
    SegmentHost. Hosts must cover ascending contiguous global-id ranges
    (the append-only doc_base invariant the engine keeps). Returns True
    when any doc died.

    Work per call: one searchsorted over the segment bases, and per
    affected segment one ragged gather of the dead docs' term hashes,
    one vocab lookup and one np.subtract.at; no per-doc Python loop."""
    if not hosts:
        return False
    gids = np.unique(np.asarray(list(global_ids), dtype=np.int64))
    if gids.size == 0:
        return False
    bases = np.array([h.doc_base for h in hosts], np.int64)
    ends = bases + np.array([h.n_docs for h in hosts], np.int64)
    # the searchsorted bucketing below is only correct under the
    # append-only invariant: segment global-id ranges are ascending and
    # contiguous from 0
    assert bases[0] == 0 and np.all(bases[1:] == ends[:-1]), (
        "delete_from_hosts requires ascending contiguous doc_base ranges"
    )
    si_of = np.searchsorted(bases, gids, side="right") - 1
    in_range = (si_of >= 0) & (gids < ends[np.clip(si_of, 0, None)])
    changed = False
    for si in np.unique(si_of[in_range]):
        host = hosts[si]
        ld = gids[in_range & (si_of == si)] - host.doc_base
        ld = ld[host.alive[ld]]
        if ld.size == 0:
            continue
        host.alive[ld] = False
        starts = host.doc_ptr[ld]
        lens = (host.doc_ptr[ld + 1] - starts).astype(np.int64)
        pos = ragged_positions(starts, lens)
        rows = np.searchsorted(host.term_hash, host.doc_hashes[pos])
        np.subtract.at(host.df, rows, 1)
        changed = True
    return changed


def synth_warmup_analysis(stats, config, nq: int, terms_per_query: int,
                          seed: int):
    """Synthetic pre-analyzed warmup batch: terms sampled df-weighted
    from the index vocabulary, so heavy and light queries both appear
    and the plan layout cache seeds a grid close to production
    traffic's. Returns (slot_h, coeff, rows_g, found_g) or None when
    there is nothing to sample."""
    if len(stats.vocab) == 0:
        return None
    rng = np.random.default_rng(seed)
    df = np.maximum(stats.df.astype(np.float64), 0.0)
    if df.sum() <= 0:
        return None
    tpq = max(1, min(terms_per_query, config.max_query_terms))
    rows = rng.choice(
        len(stats.vocab), size=(nq, tpq), p=df / df.sum()
    ).astype(np.int32)
    s_full = config.max_query_terms
    slot_h = np.zeros((nq, s_full), np.uint64)
    coeff = np.zeros((nq, s_full), F32)
    rows_g = np.zeros((nq, s_full), np.int32)
    found_g = np.zeros((nq, s_full), bool)
    slot_h[:, :tpq] = stats.vocab[rows]
    coeff[:, :tpq] = F32(1.0)
    rows_g[:, :tpq] = rows
    found_g[:, :tpq] = True
    return slot_h, coeff, rows_g, found_g


def slice_active_slots(slot_h: np.ndarray, coeff: np.ndarray):
    """Trim trailing all-zero slot columns to a pow-2 width (only
    trailing zero columns are safe to cut: zero-coeff slots may sit
    between active ones in hash order)."""
    nz = coeff > 0
    last = np.where(
        nz.any(axis=1), nz.shape[1] - np.argmax(nz[:, ::-1], axis=1), 1
    )
    s_active = min(_pow2_at_least(int(last.max()), lo=2), coeff.shape[1])
    return slot_h[:, :s_active], coeff[:, :s_active]


def active_slots(analysis):
    """The frontend's analysis (slot_h, coeff, rows_g, found_g) with its
    slots cut to the active pow-2 width (slice_active_slots); rows_g and
    found_g may be None (no global rows: looked up per segment)."""
    slot_h, coeff, rows_g, found_g = analysis
    n_slots = slot_h.shape[1]
    slot_h, coeff = slice_active_slots(slot_h, coeff)
    s = coeff.shape[1]
    if rows_g is not None and s != n_slots:
        rows_g, found_g = rows_g[:, :s], found_g[:, :s]
    return slot_h, coeff, rows_g, found_g


def no_hits(nq: int, k: int):
    """(ids, scores) of a batch that has nothing to search."""
    return np.full((nq, k), -1, np.int64), np.full((nq, k), -1, np.int64)


def fill_buckets(plan_cache, key, natural, rows_p, a_p, cols, split,
                 blocks):
    """The host bucket fill of one plan, shared by both engines: the
    natural plan [(plan-row indices, n_blocks, block, r_c)] fitted into
    the plan-layout cache's cells under `key` (without a cache, each
    bucket's rows rounded up to a power of two), and per bucket its
    padded (bq, S) rows and f32 coefficients and, when splitting, its
    (bq, 2) piece columns, appended to `blocks` = ([rows], [coefficients],
    [columns]). Padding rows, and every row of a plan without pieces
    (cols None), take the whole-row piece (0, P), so the columns stay
    aligned with the bucket offsets. Returns (buckets, idxs): per bucket
    (n_blocks, block, bq, r_c) and (plan-row indices, bq)."""
    if plan_cache is not None:
        cells = plan_cache.canonicalize(key, natural, rows_p.shape[0])
    else:
        cells = [(idx, nb, blk, rc, _pow2_at_least(len(idx)))
                 for idx, nb, blk, rc in natural]
    r_subs, a_subs, c_subs = blocks
    s = rows_p.shape[1]
    buckets, idxs = [], []
    for idx, n_blocks, block, r_c, bq in cells:
        r_sub = np.zeros((bq, s), np.int32)
        a_sub = np.zeros((bq, s), F32)
        r_sub[: len(idx)] = rows_p[idx]
        a_sub[: len(idx)] = a_p[idx]
        r_subs.append(r_sub)
        a_subs.append(a_sub)
        if split:
            c_sub = np.zeros((bq, 2), np.int32)
            c_sub[:, 1] = builder.SPLIT_QUANTILES
            if cols is not None:
                c_sub[: len(idx)] = cols[idx]
            c_subs.append(c_sub)
        buckets.append((n_blocks, block, bq, r_c))
        idxs.append((idx, bq))
    return buckets, idxs


def piece_map(cols, qidx, pno, n_rows: int):
    """What _collect needs of a plan's doc-range pieces: None where its
    rows are the queries, else (qidx, pno, most pieces of a query, plan
    rows)."""
    if cols is None:
        return None
    return qidx, pno, int(pno.max()) + 1 if len(pno) else 1, n_rows


def merge_pieces(v, g, pm, nq: int, k: int):
    """Each query's top k over its doc-range pieces' ranked lists (v, g),
    one row a piece: the pieces are doc-disjoint, so the merge of their
    top ks is the unsplit ranking. Keeps the dtype of v and g."""
    qidx, pno, mmax, _n = pm
    if mmax <= 1:
        return v, g
    pv = np.full((nq, mmax, k), -1, v.dtype)
    pg = np.full((nq, mmax, k), -1, g.dtype)
    pv[qidx, pno] = v
    pg[qidx, pno] = g
    return _merge_ranked(pv.reshape(nq, mmax * k), pg.reshape(nq, mmax * k),
                         k)


class ServingEngine:
    """The serving path that SearchEngine and DistributedSearchEngine
    (parallel/dist.py) share: the scorer mode, the request check,
    search, search_stream with its re-analysis rule, search_rerank,
    warmup, preplan's loop, the block families and the split gate. A
    subclass supplies `scorer_modes`, the modes it accepts, and:

    - `_snapshot()`: None where there is no index to serve, else the
      tuple of objects a batch's analysis holds for, the global stats
      last. search_stream re-analyzes a prefetched batch whose snapshot
      is no longer the engine's, object for object.
    - `_natural_plans(analysis, k, mode, families)`: per plan-layout
      key, the batch's plan rows and natural plan (preplan).
    - `_dispatch(analysis, k)`: the host planning and the enqueued device
      step of a batch, from the frontend's analysis (slot_h, coeff,
      rows_g, found_g); nothing in it waits on the device.
    - `_collect(fut)`: the device->host read and the (ids, scores).
    - `_rerank_dots(qemb, gids, dim)`: search_rerank's candidate dots
      and squared norms on the device.

    Scorer modes: "fused" (the hand-written CUDA kernel; the default on
    CUDA), "fused_dv" (SearchEngine only: the same kernel over one
    interleaved doc|value plane), "xla" (the plain PyTorch scorer; the
    default on the CPU; "plain" is its alias) and "xla_rank" (the plain
    pack, then the rank-only kernel). All give the same ids and scores."""

    scorer_modes: tuple = ()
    # search's phase timers, as the reference records them: its single
    # engine times search.analyze and search.score, its sharded one none
    search_phases = True

    def __init__(self, config, home, graph_device) -> None:
        self.config = config or IndexConfig()
        self.frontend = QueryFrontend(self.config)
        self._home = home  # the device the default scorer follows
        # None = "fused" on CUDA, "xla" on the CPU (scorer_mode)
        self.scorer: str | None = None
        # the index is built on the device; False takes the host build
        # path, which gives the same planes and results
        self.device_build: bool = True
        # smallest per-bucket n_blocks budget (pow-2)
        self.plan_min_blocks = 4
        # stable plan layouts (the reference's PlanLayoutCache): natural
        # per-batch bucket plans are fitted into a per-engine grid of
        # cells, so kernel shapes and workspace sizes repeat per batch
        self.plan_cache: PlanLayoutCache | None = PlanLayoutCache()
        # doc-range splitting (ops/schedule.py split_pieces): queries
        # needing more compacted candidate rows than this are cut into
        # doc-disjoint pieces that rank in smaller regions and merge
        # exactly. None = off (the reference's default). Only the fused
        # scorer with one block family takes it (_split_active).
        self.split_rows: int | None = None
        # the compiled batch step on the card (engine/step_graph.py);
        # without one the step runs eagerly
        self._graphs = (
            StepGraphs(graph_device) if graph_device is not None else None
        )

    @property
    def scorer_mode(self) -> str:
        """The active scorer (the class docstring's modes)."""
        if self.scorer is not None:
            mode = SCORER_ALIASES.get(self.scorer, self.scorer)
            if mode not in self.scorer_modes:
                raise ValueError(f"unknown scorer {self.scorer!r}")
            return mode
        return "fused" if self._home.type == "cuda" else "xla"

    def _mode_for(self, k: int) -> str:
        """The scorer mode serving k: "fused_dv" is downgraded to
        "fused" for k > 128, which the plain scorer serves over the
        standard planes (the reference's dispatcher does the same)."""
        mode = self.scorer_mode
        return "fused" if mode == "fused_dv" and k > MAX_K else mode

    def _families(self, mode: str):
        """The planner's scorer-tuned block families (ops/schedule.py)."""
        return FUSED_FAMILIES if mode.startswith("fused") else DEFAULT_FAMILIES


    def _split_active(self, mode: str, k: int, families) -> bool:
        """Splitting serves only the fused scorer with one block family
        (ops/schedule.py split_pieces), for k the kernel serves."""
        return (
            self.split_rows is not None
            and mode == "fused"
            and k <= MAX_K
            and len(families) == 1
        )

    def _check_request(self, k: int) -> None:
        """Raise on an unknown scorer name or k < 1."""
        self.scorer_mode  # noqa: B018 — validates the scorer name
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")

    def _scale_clip(self):
        """The step's f32 fixed-point scale and coefficient clip."""
        scale = float(F32(2.0**self.config.scoring.scale_bits))
        clip = float(
            F32(int(spec.quant_clip_max(self.config.max_query_terms)))
        )
        return scale, clip

    def search(self, queries, k: int = 10):
        """Batched search: (ids, scores) int64 arrays of shape (nq, k),
        ranked by (fixed-point score desc, global doc id asc)."""
        self._check_request(k)
        nq = len(queries)
        snap = self._snapshot()
        if nq == 0 or snap is None:
            return no_hits(nq, k)
        phase = prof.phase if self.search_phases else nullcontext
        with phase("search.analyze"):
            analysis = self.frontend.analyze_rows(queries, snap[-1])
        with phase("search.score"):
            return self._collect(self._dispatch(analysis, k))

    def search_stream(self, query_batches, k: int = 10, depth: int = 2):
        """Pipelined serving loop: yields (ids, scores) per input batch,
        keeping up to `depth` batches in flight; text analysis of the
        next batches runs on a worker thread. Analysis is re-run if the
        engine was mutated between prefetch and dispatch (the prefetched
        rows hold only for the index they were analyzed against)."""
        self._check_request(k)

        def analyze_job(queries):
            snap = self._snapshot()  # identity-checked at dispatch
            if len(queries) == 0 or snap is None:
                return None
            with dispatch_span(self._graphs, "stream.analyze"):
                return snap, self.frontend.analyze_rows(queries, snap[-1])

        def dispatch_job(queries, res):
            now = self._snapshot()
            if res is not None and (
                now is None or any(a is not b for a, b in zip(res[0], now))
            ):
                res = analyze_job(queries)  # engine mutated mid-stream
            if res is None and len(queries) and now is not None:
                res = analyze_job(queries)  # built mid-stream
            if res is None:
                empty = no_hits(len(queries), k)
                return lambda: empty
            return partial(self._collect, self._dispatch(res[1], k))

        yield from pipelined_stream(
            query_batches, depth, analyze_job, dispatch_job,
            partial(dispatch_span, self._graphs),
        )

    def warmup(
        self,
        queries=None,
        nq: int = 8192,
        k: int = 10,
        terms_per_query: int = 8,
        seed: int = 0,
    ) -> None:
        """Run one batch before traffic arrives: builds the kernel
        library and seeds the plan layouts. Without `queries`, a
        synthetic batch samples terms df-weighted from the vocabulary."""
        snap = self._snapshot()
        if snap is None or self.n_docs_total == 0:
            return
        if queries is not None:
            self.search(queries, k=k)
            return
        self._check_request(k)
        batch = synth_warmup_analysis(
            snap[-1], self.config, nq, terms_per_query, seed
        )
        if batch is not None:
            self._collect(self._dispatch(batch, k))

    def search_rerank(self, queries, k: int = 10, dim: int = 256,
                      candidates: int = 64):
        """Hybrid retrieval: lexical candidate generation (top
        max(k, candidates)), then a dense feature-hash rerank whose
        candidate gather and exact integer dots run on the device
        (`_rerank_dots`); only the f64 cosine and the quantized ordering
        run on the host, from exact integers. Returns (ids,
        rerank_scores_int, lexical_scores_int) int64 (nq, k), ranked
        (rerank desc, lexical desc, gid asc); the same for both engines,
        bit for bit."""
        from ..ops.rerank import query_embeddings_int, rerank_order_int

        self._check_request(k)
        kk = max(k, candidates)
        nq = len(queries)
        snap = self._snapshot()
        if nq == 0 or snap is None or self.n_docs_total == 0:
            gids, lex = self.search(queries, k=kk)
            return gids[:, :k], np.full((nq, k), -1, np.int64), lex[:, :k]
        # one frontend pass feeds both stages
        analysis = self.frontend.analyze_rows(queries, snap[-1])
        gids, lex = self._collect(self._dispatch(analysis, kk))
        qemb, ssq_q = query_embeddings_int(analysis[0], analysis[1], dim)
        dots, cand_ssq = self._rerank_dots(qemb, gids, dim)
        return rerank_order_int(
            dots.cpu().numpy(), ssq_q, cand_ssq.cpu().numpy(), lex, gids, k
        )

    def preplan(self, query_batches, k: int = 10) -> None:
        """Host-only: converge the plan-layout cache over representative
        query batches before the first dispatch (numpy planning; with
        splitting on, the quantile tables are built once first)."""
        if self.plan_cache is None or self._snapshot() is None:
            return
        self._check_request(k)
        mode = self._mode_for(k)
        families = self._families(mode)
        per_key: dict = {}
        for queries in query_batches:
            analysis = self.frontend.analyze_rows(
                queries, self._snapshot()[-1])
            for key, n_rows, natural in self._natural_plans(
                analysis, k, mode, families
            ):
                ent = per_key.setdefault(key, [0, []])
                ent[0] = max(ent[0], n_rows)
                ent[1].append(natural)
        for key, (n_rows, naturals) in per_key.items():
            self.plan_cache.seed_plans(key, naturals, n_rows)


class SearchEngine(ServingEngine):
    """Single-process engine over one or more CSR segments on one torch
    device. `device=None` means "cuda": on a machine without CUDA it
    raises instead of running elsewhere; the CPU is asked for by name.
    It serves through ServingEngine's path."""

    scorer_modes = ("fused", "fused_dv", "xla", "xla_rank")

    def __init__(self, config: IndexConfig | None = None, device=None):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"SearchEngine(device={str(device)!r}): CUDA is not "
                "available on this machine"
            )
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device}")
        self.device = device
        super().__init__(
            config, device, device if device.type == "cuda" else None
        )
        self.segments: list = []  # list[[SegmentHost, SegmentDevice]]
        self.stats = GlobalStats(
            np.zeros(0, np.uint64), np.zeros(0, np.int32), 0, 0
        )
        self.n_docs_total = 0
        # segment lifecycle policy (the reference's): compact when the
        # segment count passes auto_compact_segments, or when tombstoned
        # docs' postings pass auto_compact_dead_frac of all postings;
        # None turns that check off (_maybe_auto_compact)
        self.auto_compact_segments: int | None = 4
        self.auto_compact_dead_frac: float | None = 0.5
        # None = scorer-tuned block families (ops/schedule.py)
        self.block_families = None
        self._drop_caches()

    # ------------------------------------------------------------- build
    def build(self, texts) -> None:
        """Build the base segment from a corpus (replaces any state)."""
        self.segments = []
        self.n_docs_total = 0
        self.add_docs(texts)

    def add_docs(self, texts) -> list:
        """Append docs as a new segment; refreshes the global df- and
        avgdl-dependent values of every segment exactly."""
        texts = list(texts)
        if not texts:
            return []
        doc_base = self.n_docs_total
        with prof.phase("build.analyze"):
            analyzed = builder.analyze_texts_fast(texts, self.config)
        self._append_segment(analyzed)
        self._refresh_stats_and_vals()
        self._maybe_auto_compact()
        return list(range(doc_base, self.n_docs_total))

    def build_streaming(self, batches) -> None:
        """Streaming build: one segment per non-empty batch of an
        iterable of doc batches, with one stats and value refresh at the
        end (a refresh per batch would be O(batches^2) work), then the
        lifecycle policy, so a many-batch build ends compacted."""
        self.segments = []
        self.n_docs_total = 0
        for batch in batches:
            batch = list(batch)
            if batch:
                self._append_segment(
                    builder.analyze_texts_fast(batch, self.config)
                )
        self._refresh_stats_and_vals()
        self._maybe_auto_compact()

    def _append_segment(self, analyzed) -> None:
        """Build one segment from analyzed docs, with its doc ids
        following the engine's last."""
        host, dev_seg = self._build_segment(analyzed, self.n_docs_total)
        self.segments.append([host, dev_seg])
        self.n_docs_total += host.n_docs

    def _build_segment(self, analyzed, doc_base: int):
        """One segment: the device build by default, the host build path
        when device_build is off (its values are left for the refresh
        that every caller runs next)."""
        if self.device_build:
            return builder.build_segment_device(
                analyzed, self.config, self.device, doc_base=doc_base
            )
        return builder.build_segment(
            analyzed, self.config, self.device, doc_base=doc_base,
            materialize=False,
        )

    def _refresh_stats_and_vals(self) -> None:
        """Re-merge global stats; re-materialize the df/avgdl-dependent
        device values of every segment (postings stay immutable)."""
        self.stats = merge_stats([h for h, _ in self.segments])
        for seg in self.segments:
            host, dev_seg = seg
            seg[1] = builder.refresh_segment_vals(
                host, dev_seg, self.config, self.stats
            )
        self._drop_caches()

    def _drop_caches(self) -> None:
        """Forget everything derived from the segments, so no cache entry
        keeps a replaced plane resident (every mutation calls this)."""
        self._rows_global = None  # per segment: term table is the vocab
        self._emb_cache: dict = {}  # dim -> (emb, ssq), _device_embeddings
        self._dv_cache: dict = {}  # segment -> (doc, val, dv), _dv_planes
        self._quant_cache: dict = {}  # segment -> (doc, offs_h, offs_d)
        self._dead_cache: dict = {}  # segment -> rows' dead postings | None
        self._last_step = None  # (step, host inputs) of the last batch
        if self._graphs is not None:
            self._graphs.clear()

    def load_segments(self, segments) -> None:
        """Serve already-built segments [(SegmentHost, SegmentDevice)]
        as they are (index/convert.py carries a reference engine's
        segments across, index/checkpoint.py a saved index): stats are
        merged, values are NOT re-derived."""
        self.segments = [list(seg) for seg in segments]
        self.n_docs_total = sum(h.n_docs for h, _ in self.segments)
        self.stats = merge_stats([h for h, _ in self.segments])
        self._drop_caches()

    def delete_docs(self, global_ids) -> None:
        """Tombstone docs and update df, N and the alive length exactly
        from the per-doc terms kept in SegmentHost (delete_from_hosts),
        then one refresh: the dead docs' values fold to +0.0 on the
        device, through a select."""
        if delete_from_hosts([h for h, _ in self.segments], global_ids):
            self._refresh_stats_and_vals()
            self._maybe_auto_compact()

    def _maybe_auto_compact(self) -> None:
        """The segment lifecycle policy: compact when the segment count
        passes auto_compact_segments, or when tombstoned docs' postings
        pass auto_compact_dead_frac of all postings."""
        if not self.segments:
            return
        if (
            self.auto_compact_segments is not None
            and len(self.segments) > self.auto_compact_segments
        ):
            self.compact()
            return
        if self.auto_compact_dead_frac is None:
            return
        dead_nnz, total_nnz = 0, 0
        for host, _ in self.segments:
            lens = np.diff(host.doc_ptr)
            dead_nnz += int(lens[~host.alive].sum())
            total_nnz += int(lens.sum())
        if total_nnz and dead_nnz / total_nnz > self.auto_compact_dead_frac:
            self.compact()

    def compact(self) -> None:
        """Merge all segments into one, dropping tombstoned docs'
        postings. Global doc ids are stable (dead ids keep empty slots
        with dl 0), so results are identical before and after.

        Vectorized: per segment one np.repeat keep-mask over the doc_ptr
        lens selects the alive docs' postings, and since segments cover
        contiguous global-id ranges, lens, dl and dead scatter as
        slices. The merged docs are built like any segment, with the
        planes in (row, doc) order."""
        if not self.segments:
            return
        n = self.n_docs_total
        hashes_parts, tfs_parts, ptr = [], [], np.zeros(n + 1, np.int64)
        dl = np.zeros(n, np.int32)
        dead = np.zeros(n, bool)
        for host, _ in self.segments:
            lens = np.diff(host.doc_ptr).astype(np.int64)
            keep_doc = host.alive
            keep_post = np.repeat(keep_doc, lens)
            lo, hi = host.doc_base, host.doc_base + host.n_docs
            ptr[lo + 1 : hi + 1] = np.where(keep_doc, lens, 0)
            dl[lo:hi] = np.where(keep_doc, host.dl, np.int32(0))
            dead[lo:hi] = ~keep_doc
            hashes_parts.append(host.doc_hashes[keep_post])
            tfs_parts.append(host.doc_tfs[keep_post])
        np.cumsum(ptr, out=ptr)
        analyzed = builder.AnalyzedDocs(
            hashes=np.concatenate(hashes_parts),
            tfs=np.concatenate(tfs_parts),
            doc_ptr=ptr,
            dl=dl,
        )
        host, dev_seg = self._build_segment(analyzed, 0)
        host.alive[dead] = False
        self.segments = [[host, dev_seg]]
        self._refresh_stats_and_vals()

    # ----------------------------------------------------- hybrid rerank
    def _device_embeddings(self, dim: int):
        """Device-resident int8 feature-hash embeddings (n_docs_total,
        dim) and int32 squared norms of the whole corpus, built on the
        device from the resident posting planes (ops/rerank.py) and
        cached until the next stats refresh or load_segments."""
        from ..ops.rerank import device_doc_embeddings_int, term_projection

        if dim in self._emb_cache:
            return self._emb_cache[dim]
        dev = self.device
        embs, ssqs = [], []
        for host, dev_seg in self.segments:
            if host.n_terms == 0 or host.n_docs == 0:
                # empty-vocabulary segment (e.g. all-stopword docs):
                # nothing projects; its docs embed as zero vectors
                embs.append(torch.zeros((host.n_docs, dim), dtype=torch.int8,
                                        device=dev))
                ssqs.append(torch.zeros(host.n_docs, dtype=torch.int32,
                                        device=dev))
                continue
            col, sign = term_projection(host.term_hash, dim)
            e, ss = device_doc_embeddings_int(
                dev_seg.post_doc, dev_seg.post_val, dev_seg.row_start,
                torch.from_numpy(col).to(dev), torch.from_numpy(sign).to(dev),
                n_docs=host.n_docs, dim=dim,
            )
            embs.append(e)
            ssqs.append(ss)
        self._emb_cache[dim] = (torch.cat(embs, 0), torch.cat(ssqs, 0))
        return self._emb_cache[dim]

    def _rerank_dots(self, qemb, gids, dim: int):
        """ServingEngine.search_rerank's device stage: the candidates'
        gather and exact integer dots against the resident embeddings
        (ops/rerank.py gather_and_dot)."""
        from ..ops.rerank import gather_and_dot

        emb, ssq = self._device_embeddings(dim)
        dev = self.device
        return gather_and_dot(
            emb, ssq, torch.from_numpy(qemb).to(dev),
            torch.from_numpy(gids.astype(np.int32)).to(dev),
        )

    def save(self, path: str) -> None:
        """Write the index as a v2 checkpoint (index/checkpoint.py), the
        format the JAX package reads and writes."""
        from ..index.checkpoint import save_engine

        save_engine(self, path)

    @classmethod
    def load(cls, path: str, device=None) -> "SearchEngine":
        """Open a v2 checkpoint saved by either package on `device`
        (None means the card, as in the constructor); the stored plane
        bits are served as they are."""
        from ..index.checkpoint import load_engine

        return load_engine(path, engine_cls=cls, device=device)

    def resident_bytes(self) -> int:
        """Device bytes held by the index's segments."""
        return sum(d.nbytes() for _, d in self.segments)

    # ------------------------------------------------------------ search
    def _snapshot(self):
        """ServingEngine's snapshot: the global stats, None without
        segments."""
        stats = self.stats
        return (stats,) if self.segments else None

    def _families(self, mode: str):
        return self.block_families or super()._families(mode)

    def _plan_key(self, si, host, s, k, mode, families):
        """Plan-layout cache key; preplan() and _dispatch must agree."""
        return (
            si, host.n_docs, host.n_terms, s, k, mode,
            families, self.plan_min_blocks, self.split_rows,
        )

    def _seg_rows_global(self):
        """Per segment: its term table IS the global vocabulary (the
        frontend's rows_g/found_g apply directly)."""
        seg_global = self._rows_global
        if seg_global is None or len(seg_global) != len(self.segments):
            seg_global = self._rows_global = [
                np.array_equal(h.term_hash, self.stats.vocab)
                for h, _ in self.segments
            ]
        return seg_global

    def _segment_plans(self, analysis, k, mode, families):
        """Per segment of a batch (si, host, plan-layout key, rows,
        found, _segment_plan's tuple), its rows the frontend's global
        rows where the segment's term table is the vocabulary, else
        looked up (segment_rows)."""
        slot_h, coeff, rows_g, found_g = active_slots(analysis)
        s = coeff.shape[1]
        seg_global = self._seg_rows_global()
        for si, (host, dev_seg) in enumerate(self.segments):
            if rows_g is not None and seg_global[si]:
                rows, found = rows_g, found_g
            else:
                rows, found = segment_rows(host.term_hash, slot_h)
            a_seg = np.where(found, coeff, F32(0.0)).astype(F32)
            key = self._plan_key(si, host, s, k, mode, families)
            yield si, host, key, rows, found, self._segment_plan(
                si, host, dev_seg, rows, found, a_seg, families, mode, k)

    def _natural_plans(self, analysis, k, mode, families):
        for _si, _h, key, _r, _f, seg in self._segment_plans(
            analysis, k, mode, families
        ):
            rows_p, _a, _c, _q, _p, natural, _n = seg
            yield key, rows_p.shape[0], natural

    def _doc_quantiles(self, si: int, host, dev_seg):
        """(offs_h, offs_d): the segment's (T, P+1) int32 doc-quantile
        table for doc-range splitting, on the host for the planner and
        on the device for the plan expansion. Built on the device from
        the resident doc plane (builder.device_row_doc_quantiles, for
        device- and host-built segments alike) and cached per segment
        while its doc plane is the same tensor (every mutation drops the
        cache)."""
        ent = self._quant_cache.get(si)
        if ent is not None and ent[0] is dev_seg.post_doc:
            return ent[1], ent[2]
        offs_d = builder.device_row_doc_quantiles(
            dev_seg.post_doc, dev_seg.indptr, dev_seg.row_start,
            builder.SPLIT_QUANTILES, host.n_docs,
        )
        offs_h = offs_d.cpu().numpy()
        self._quant_cache[si] = (dev_seg.post_doc, offs_h, offs_d)
        return offs_h, offs_d

    def _dead_rows(self, si: int, host):
        """Per term row of segment si its tombstoned docs' postings: the
        row's length less its live df (delete_from_hosts keeps df exact
        over the live docs); None where the segment has none. Cached per
        segment until the next mutation."""
        if si not in self._dead_cache:
            dead = None
            if not host.alive.all():
                dead = np.diff(host.indptr) - host.df
                if not dead.any():
                    dead = None
            self._dead_cache[si] = dead
        return self._dead_cache[si]

    def _segment_plan(self, si, host, dev_seg, rows, found, a_seg,
                      families, mode, k):
        """Shared by preplan and _dispatch: the segment's natural plan
        and, when splitting, its piece table. Returns (rows_p, a_p, cols,
        qidx, pno, natural, pairs); cols/qidx/pno are None when the plan
        rows are the queries themselves; pairs is (nq,) int64, the
        (query, posting) pairs the plan asks the kernels to score for
        each query (a split query's pieces sum to its postings)."""
        compact = mode.startswith("fused") and k <= MAX_K
        # empty segments have no postings, no quantile table (T = 0) and
        # nothing to split; they take the unsplit plan (zero blocks)
        if len(host.indptr) < 2:
            natural = plan_batch(
                host.indptr, rows, found, families=families,
                min_blocks=self.plan_min_blocks, compact=compact,
            )
            return (rows, a_seg, None, None, None, natural,
                    np.zeros(rows.shape[0], np.int64))
        lens = (host.indptr[rows + 1] - host.indptr[rows]) * found
        pairs = lens.sum(axis=1, dtype=np.int64)
        if not self._split_active(mode, k, families):
            natural = plan_batch(
                host.indptr, rows, found, families=families,
                min_blocks=self.plan_min_blocks, compact=compact, lens=lens,
            )
            return rows, a_seg, None, None, None, natural, pairs
        offs_h, _offs_d = self._doc_quantiles(si, host, dev_seg)
        qidx, pno, cols, lens_p = split_pieces(
            lens, rows, offs_h, self.split_rows, families[0][1],
            builder.SPLIT_QUANTILES,
        )
        natural = plan_batch(
            host.indptr, rows[qidx], found[qidx], families=families,
            min_blocks=self.plan_min_blocks, compact=compact, lens=lens_p,
        )
        return rows[qidx], a_seg[qidx], cols, qidx, pno, natural, pairs

    def _dv_planes(self):
        """Per segment the (X + 8, 256) interleaved doc|value plane of
        the fused_dv scorer (ops/fused_dv.py interleave_planes), built on
        the device and cached while the segment's planes are the same
        tensors (every mutation drops the cache)."""
        from ..ops.fused_dv import interleave_planes

        out = []
        for si, (_host, dev_seg) in enumerate(self.segments):
            ent = self._dv_cache.get(si)
            if (
                ent is None
                or ent[0] is not dev_seg.post_doc
                or ent[1] is not dev_seg.post_val
            ):
                ent = (
                    dev_seg.post_doc, dev_seg.post_val,
                    interleave_planes(dev_seg.post_doc, dev_seg.post_val),
                )
                self._dv_cache[si] = ent
            out.append(ent[2])
        return out

    def _dispatch(self, analysis, k: int):
        """Host planning + the device work of one query batch, from the
        frontend's analysis (slot_h, coeff, rows_g, found_g). Host work:
        slot->row lookup per segment (skipped where the segment's term
        table is the global vocabulary), splitting into doc-range pieces
        when on, bucketing (fill_buckets), and one stacked (rows,
        coefficient bits) array pair (plus the pieces' quantile columns);
        those are the only host->device copies, from pinned memory on
        the card, where the step is the plan's CUDA graph
        (engine/step_graph.py). Returns the in-flight device output plus
        assembly metadata, so callers can pipeline batches: nothing here
        waits on the card."""
        mode = self._mode_for(k)
        self._check_request(k)
        with dispatch_span(self._graphs, "dispatch.plan"):
            nq = analysis[1].shape[0]
            families = self._families(mode)
            split = self._split_active(mode, k, families)
            plan = []  # per seg (n_docs, s, ((nb, blk, bq, rc), ...))
            slots = []  # per segment: its plan-layout key
            idx_map = []  # per segment: list of (plan-row indices, bq)
            piece_maps = []  # per segment: None | (qidx, pno, mmax, rows)
            blocks = ([], [], [])  # rows, coefficients, piece columns
            pairs = tiled_pairs = dead_pairs = 0
            for si, host, key, rows, found, seg in self._segment_plans(
                analysis, k, mode, families
            ):
                rows_p, a_p, cols, qidx, pno, natural, q_pairs = seg
                s = rows.shape[1]
                pairs += int(q_pairs.sum())
                if self._graphs is not None:  # dispatch_span's rule
                    dead = self._dead_rows(si, host)
                    if dead is not None:
                        dead_pairs += int(
                            (dead[rows] * found).sum(dtype=np.int64))
                buckets, idxs = fill_buckets(
                    self.plan_cache, key, natural, rows_p, a_p, cols, split,
                    blocks,
                )
                slots.append(key if self.plan_cache is not None else None)
                for (idx, _), (n_blocks, _blk, _bq, r_c) in zip(
                    idxs, buckets
                ):
                    if tiled_route(mode=mode, k=k, split=split, r_c=r_c,
                                   n_blocks=n_blocks, s=s):
                        tiled_pairs += int(q_pairs[idx].sum())
                plan.append((host.n_docs, s, tuple(buckets)))
                idx_map.append(idxs)
                piece_maps.append(piece_map(cols, qidx, pno, rows_p.shape[0]))
            # the read-back: the real (non-pad) output rows are gathered
            # on the device before the single device->host read, or, where
            # the step merges the segments, each query's stacked row in
            # each segment (-1: none) leads it to its lists; either table
            # rides in rows_cat's tail
            merge = _device_merges(len(plan), split, k)
            pos = np.full((nq, len(plan)), -1, np.int32) if merge else None
            offs = []
            off = 0
            for si, idxs in enumerate(idx_map):
                for idx, bq in idxs:
                    at = off + np.arange(len(idx), dtype=np.int32)
                    if merge:
                        pos[idx, si] = at
                    else:
                        offs.append(at)
                    off += bq
            if merge:
                flat, n_real = pos.reshape(-1), nq
            else:
                flat = np.concatenate(offs)
                n_real = len(flat)
            if split:
                # piece counts vary with traffic; round the gather size
                # up so the step's keys stay few (the JAX package's rule:
                # the pad gathers row 0, rows past the consumed range
                # that _collect never reads)
                n_real = -(-n_real // 256) * 256
            # the words _batch_step reads: n_real x S with merge, else n_real
            n_tail = len(flat) if merge else n_real
            tail = np.zeros((-(-n_tail // s), s), np.int32)
            tail.reshape(-1)[: len(flat)] = flat
            r_all = np.concatenate(blocks[0] + [tail], axis=0)
            inputs = (r_all, np.concatenate(blocks[1], axis=0).view(np.int32))
            if split:
                inputs += (np.concatenate(blocks[2]),)
            if self._graphs is not None:  # dispatch_span's rule
                prof.count("step.pairs", pairs)
                prof.count("step.tiled_pairs", tiled_pairs)
                prof.count("step.dead_pairs", dead_pairs)
                prof.count("step.segment_merge_queries",
                           nq if len(plan) > 1 else 0)
                prof.count("step.device_merge_queries", nq if merge else 0)
        scale, clip = self._scale_clip()
        with dispatch_span(self._graphs, "dispatch.enqueue"):
            segs = [(h.n_docs, h.doc_base, d) for h, d in self.segments]
            dv = self._dv_planes() if mode == "fused_dv" else None
            quant = (
                [self._doc_quantiles(si, h, d)[1]
                 for si, (h, d) in enumerate(self.segments)]
                if split else None
            )
            split_p = builder.SPLIT_QUANTILES if split else 0
            plan = tuple(plan)
            step = partial(
                _batch_step, segs, plan=plan, k=k, scale=scale, clip=clip,
                mode=mode, n_real=n_real, dv_planes=dv, offs_devs=quant,
                split_p=split_p, merge=merge,
            )
            resident = resident_key(
                [t for _n, _b, d in segs
                 for t in (d.post_doc, d.post_val, d.indptr, d.row_start)]
                + (dv or []) + (quant or []),
                [b for _n, b, _d in segs],
            )
            key = step_key(plan, k, scale, clip, mode, n_real, split_p,
                           inputs, resident, merge=merge)
            self._last_step = (step, inputs)
            out = run_step(self._graphs, tuple(slots), key, step, inputs)
        # idx_map None: the step's output is already the answer
        return out, None if merge else idx_map, piece_maps, nq, k

    def _step_replayer(self):
        """A zero-argument callable running the last batch's device step
        again into a fresh output: its graph's replay on the card, the
        eager step on the CPU (the bench's step leg)."""
        if self._graphs is not None:
            return self._graphs.replayer()
        step, inputs = self._last_step
        return partial(step, *(torch.from_numpy(a) for a in inputs))

    def _collect(self, fut):
        """Force the device->host read of a dispatched batch and
        assemble (ids, scores). Where the step merged the segments
        (_device_merges) the read is the answer; otherwise a split
        query's doc-disjoint pieces, and then the segments, merge by
        (score desc, gid asc) on the host. On the card the read is span
        collect.wait, the rest collect.assemble, and in it the host's
        merge of several segments collect.merge_segments."""
        out, idx_map, piece_maps, nq, k = fut
        with dispatch_span(self._graphs, "collect.wait"):
            host = out.cpu().numpy()
        with dispatch_span(self._graphs, "collect.assemble"):
            if idx_map is None:
                return (host[:, k:].astype(np.int64),
                        host[:, :k].astype(np.int64))
            all_vals, all_gids = [], []
            off = 0  # rows are the gathered REAL rows, bq pad dropped
            for idxs, pm in zip(idx_map, piece_maps):
                n_rows = nq if pm is None else pm[3]
                seg_v = np.full((n_rows, k), -1, np.int32)
                seg_g = np.full((n_rows, k), -1, np.int32)
                for idx, _bq in idxs:
                    seg_v[idx] = host[off : off + len(idx), :k]
                    seg_g[idx] = host[off : off + len(idx), k:]
                    off += len(idx)
                if pm is not None:
                    seg_v, seg_g = merge_pieces(seg_v, seg_g, pm, nq, k)
                all_vals.append(seg_v)
                all_gids.append(seg_g)
            if len(all_vals) == 1:
                v, g = all_vals[0], all_gids[0]
            else:
                with dispatch_span(self._graphs, "collect.merge_segments"):
                    v, g = _merge_ranked(
                        np.concatenate(all_vals, axis=1),
                        np.concatenate(all_gids, axis=1), k,
                    )
            return g[:nq].astype(np.int64), v[:nq].astype(np.int64)


def _device_merges(n_segments: int, split: bool, k: int) -> bool:
    """Whether a batch's step merges its segments' ranked lists on the
    device (ops/segment_merge.py), by what the batch shows: more than one
    segment, no doc-range pieces, and k the merge kernel serves. Else
    _collect merges on the host (_merge_ranked)."""
    return n_segments > 1 and not split and k <= MAX_K


def _merge_ranked(vc: np.ndarray, gc: np.ndarray, k: int):
    """Top k of each row of (vals, gids) by (score desc, gid asc); dead
    (-1, -1) entries sink and come out as (-1, -1)."""
    order = np.lexsort((gc, -vc.astype(np.int64)), axis=-1)[:, :k]
    v = np.take_along_axis(vc, order, axis=1)
    g = np.take_along_axis(gc, order, axis=1)
    return np.where(v > 0, v, -1), np.where(v > 0, g, -1)
