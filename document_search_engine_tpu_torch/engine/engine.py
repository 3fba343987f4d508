"""SearchEngine over torch device segments: build -> search_stream.

Port of `document_search_engine_tpu/engine/engine.py` for the serving
slice: build/add_docs, the stats and value refresh, search,
search_stream, preplan and warmup, with the batch step (`_batch_step`)
running every (segment x bucket) sub-call of a batch and producing one
stacked int32 output, so a batch costs one device->host read.

Scorer modes: "fused" (the hand-written CUDA kernel, ops/fused.py; the
default on CUDA) and "plain" (the plain PyTorch scorer, ops/packed.py;
the default on the CPU). On CPU tensors the fused wrapper itself takes
the plain version. Both modes give the same ids and integer scores.

Paths outside the slice raise NotImplementedError naming their ROADMAP
item rather than taking another path: doc-range splitting (A11), the
fused_dv and xla_rank modes (A15, A10), rerank (A12), delete, compact
and streaming build (A7), save/load (A8), and k > 16 in fused mode (A9).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..index import builder
from ..index.csr import GlobalStats, merge_stats
from ..ops.schedule import DEFAULT_FAMILIES, FUSED_FAMILIES, plan_batch
from ..shared import IndexConfig, PlanLayoutCache, spec
from .query import QueryFrontend, segment_rows

F32 = np.float32
SCORER_MODES = ("fused", "plain")


def _pow2_at_least(n: int, lo: int = 1) -> int:
    n = max(n, lo)
    return 1 << int(np.ceil(np.log2(n)))


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the torch package yet (ROADMAP {item})"
    )


def _batch_step(
    segments,  # list of (n_docs, doc_base, SegmentDevice)
    rows_cat: torch.Tensor,  # (sum of bucket bq + tail, S) i32 term rows
    cbits_cat: torch.Tensor,  # (sum of bucket bq, S) i32 coefficient bits
    plan,  # per segment (n_docs, s, ((n_blocks, block, bq, r_c), ...))
    k: int,
    scale: float,
    clip: float,
    mode: str,  # "fused" | "plain"
    n_real: int,  # readback-trim gather size
):
    """The device work of one batch: per (segment x bucket) the plan
    tables expand on the device from the shipped (bq, S) rows and
    coefficient bits, the scorer runs, and the gid mask
    where(v > 0, dloc + doc_base, -1) applies. Returns ONE (n_real, 2k)
    int32 tensor — per-bucket [vals | gids] stacked in plan order, with
    the pow-2 bq padding rows dropped by a gather whose indices ride in
    rows_cat's tail (the same host->device copy)."""
    from ..ops.fused import expand_plan_tables, fused_search, key_bits_for
    from ..ops.packed import search_packed_tables

    out_v, out_g = [], []
    off = 0
    for (n_docs, doc_base, dev_seg), (_nd, s, buckets) in zip(segments, plan):
        for n_blocks, block, bq, r_c in buckets:
            rows_b = rows_cat[off : off + bq]
            cbits_b = cbits_cat[off : off + bq]
            off += bq
            sr, rm, ab, dst = expand_plan_tables(
                dev_seg.row_start, dev_seg.indptr, rows_b, cbits_b,
                n_blocks, block,
            )
            if mode == "fused":
                v, dloc = fused_search(
                    dev_seg.post_doc, dev_seg.post_val, sr, rm, ab, dst,
                    n_blocks=n_blocks, block=block, s=s, k=k,
                    n_docs=n_docs, scale=scale, clip=clip, r_c=r_c,
                    key_bits=key_bits_for(s, n_docs),
                )
                g = torch.where(v > 0, dloc + doc_base, torch.full_like(v, -1))
            else:
                v, g = search_packed_tables(
                    dev_seg.post_doc, dev_seg.post_val, sr, rm, ab,
                    scale, clip, doc_base, n_blocks=n_blocks, block=block,
                    s=s, k=k, n_docs=n_docs,
                )
            out_v.append(v)
            out_g.append(g)
    stacked = torch.cat([torch.cat(out_v, 0), torch.cat(out_g, 0)], 1)
    s_cols = rows_cat.shape[1]
    n_extra = -(-n_real // s_cols)
    idx_flat = rows_cat[off : off + n_extra].reshape(-1)[:n_real]
    return stacked.index_select(0, idx_flat.long())


def pipelined_stream(query_batches, depth, analyze_job, dispatch_job):
    """Serving loop: a worker thread prefetches analysis up to 2 batches
    ahead while the main thread dispatches and drains a depth-N
    in-flight window. analyze_job(queries) -> analysis snapshot or None
    (safe on a worker thread); dispatch_job(queries, analysis) -> a
    thunk producing that batch's (ids, scores) when called."""
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
            res = fut_an.result()
            submit_next()
            inflight.append(dispatch_job(queries, res))
            if len(inflight) >= depth:
                yield inflight.popleft()()
        while inflight:
            yield inflight.popleft()()


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


class SearchEngine:
    """Single-process engine over one or more CSR segments on one torch
    device. `device` is explicit: "cuda" on a machine without CUDA
    raises instead of running elsewhere."""

    def __init__(self, config: IndexConfig | None = None, device="cpu"):
        self.config = config or IndexConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"SearchEngine(device={str(self.device)!r}): CUDA is not "
                "available on this machine"
            )
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.frontend = QueryFrontend(self.config)
        self.segments: list = []  # list[[SegmentHost, SegmentDevice]]
        self.stats = GlobalStats(
            np.zeros(0, np.uint64), np.zeros(0, np.int32), 0, 0
        )
        self.n_docs_total = 0
        # None = "fused" on CUDA, "plain" on the CPU (scorer_mode)
        self.scorer: str | None = None
        # segment lifecycle policy (the reference's): compact when the
        # segment count passes this bound; compaction itself is A7
        self.auto_compact_segments: int | None = 4
        # None = scorer-tuned block families (ops/schedule.py)
        self.block_families = None
        # smallest per-bucket n_blocks budget (pow-2)
        self.plan_min_blocks = 4
        # stable plan layouts (the reference's PlanLayoutCache): natural
        # per-batch bucket plans are fitted into a per-engine grid of
        # cells, so kernel shapes and workspace sizes repeat per batch
        self.plan_cache: PlanLayoutCache | None = PlanLayoutCache()
        # doc-range splitting threshold (ROADMAP A11); must stay None
        self.split_rows: int | None = None
        self._rows_global = None

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
        if (
            self.auto_compact_segments is not None
            and len(self.segments) + 1 > self.auto_compact_segments
        ):
            # the reference compacts here; refuse before any state changes
            raise _not_ported(
                f"add_docs past auto_compact_segments="
                f"{self.auto_compact_segments} (compaction)", "A7",
            )
        analyzed = builder.analyze_texts_fast(texts, self.config)
        doc_base = self.n_docs_total
        host, dev_seg = builder.build_segment_device(
            analyzed, self.config, self.device, doc_base=doc_base
        )
        self.segments.append([host, dev_seg])
        self.n_docs_total += host.n_docs
        self._refresh_stats_and_vals()
        return list(range(doc_base, self.n_docs_total))

    def _refresh_stats_and_vals(self) -> None:
        """Re-merge global stats; re-materialize the df/avgdl-dependent
        device values of every segment (postings stay immutable)."""
        self.stats = merge_stats([h for h, _ in self.segments])
        for seg in self.segments:
            host, dev_seg = seg
            seg[1] = builder.refresh_segment_vals(
                host, dev_seg, self.config, self.stats
            )
        self._rows_global = None

    def load_segments(self, segments) -> None:
        """Serve already-built segments [(SegmentHost, SegmentDevice)]
        as they are (index/convert.py carries a reference engine's
        segments across): stats are merged, values are NOT re-derived."""
        self.segments = [list(seg) for seg in segments]
        self.n_docs_total = sum(h.n_docs for h, _ in self.segments)
        self.stats = merge_stats([h for h, _ in self.segments])
        self._rows_global = None

    def build_streaming(self, batches) -> None:
        raise _not_ported("build_streaming", "A7")

    def delete_docs(self, global_ids) -> None:
        raise _not_ported("delete_docs", "A7")

    def compact(self) -> None:
        raise _not_ported("compact", "A7")

    def search_rerank(self, queries, k: int = 10, **_kw):
        raise _not_ported("search_rerank", "A12")

    def save(self, path: str) -> None:
        raise _not_ported("save", "A8")

    @classmethod
    def load(cls, path: str):
        raise _not_ported("load", "A8")

    def resident_bytes(self) -> int:
        """Device bytes held by the index's segments."""
        return sum(d.nbytes() for _, d in self.segments)

    # ------------------------------------------------------------ search
    @property
    def scorer_mode(self) -> str:
        """Active scorer: "fused" (the CUDA kernel; default on CUDA) or
        "plain" (the plain PyTorch scorer; default on the CPU)."""
        if self.scorer is not None:
            if self.scorer in ("fused_dv", "xla_rank"):
                raise _not_ported(
                    f"scorer {self.scorer!r}",
                    "A15" if self.scorer == "fused_dv" else "A10",
                )
            if self.scorer not in SCORER_MODES:
                raise ValueError(f"unknown scorer {self.scorer!r}")
            return self.scorer
        return "fused" if self.device.type == "cuda" else "plain"

    def _families(self, mode: str):
        return self.block_families or (
            FUSED_FAMILIES if mode == "fused" else DEFAULT_FAMILIES
        )

    def _check_slice(self, mode: str, k: int) -> None:
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if self.split_rows is not None:
            raise _not_ported("doc-range splitting (split_rows)", "A11")
        if mode == "fused" and k > 16:
            raise _not_ported(f"k={k} > 16 in the fused scorer", "A9")

    def search(self, queries, k: int = 10):
        """Batched search: (ids, scores) int64 arrays of shape (nq, k),
        ranked by (fixed-point score desc, global doc id asc)."""
        self._check_slice(self.scorer_mode, k)
        nq = len(queries)
        if nq == 0 or not self.segments:
            return (
                np.full((nq, k), -1, np.int64),
                np.full((nq, k), -1, np.int64),
            )
        slot_h, coeff, rows_g, found_g = self.frontend.analyze_rows(
            queries, self.stats
        )
        return self._collect(self._dispatch(slot_h, coeff, k, rows_g, found_g))

    def search_stream(self, query_batches, k: int = 10, depth: int = 2):
        """Pipelined serving loop: yields (ids, scores) per input batch,
        keeping up to `depth` batches in flight; text analysis of the
        next batches runs on a worker thread. Analysis is re-run if the
        engine was mutated between prefetch and dispatch."""
        self._check_slice(self.scorer_mode, k)

        def analyze_job(queries):
            stats = self.stats  # snapshot: identity-checked at dispatch
            if len(queries) == 0 or not self.segments:
                return None
            return (stats, self.frontend.analyze_rows(queries, stats))

        def dispatch_job(queries, res):
            if res is not None and res[0] is not self.stats:
                res = analyze_job(queries)  # engine mutated mid-stream
            if res is None and len(queries) and self.segments:
                res = analyze_job(queries)  # built mid-stream
            if res is None:
                nq = len(queries)
                empty = (
                    np.full((nq, k), -1, np.int64),
                    np.full((nq, k), -1, np.int64),
                )
                return lambda e=empty: e
            _stats, (slot_h, coeff, rows_g, found_g) = res
            fut = self._dispatch(slot_h, coeff, k, rows_g, found_g)
            return partial(self._collect, fut)

        yield from pipelined_stream(
            query_batches, depth, analyze_job, dispatch_job
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
        if not self.segments or self.n_docs_total == 0:
            return
        if queries is not None:
            self.search(queries, k=k)
            return
        self._check_slice(self.scorer_mode, k)
        batch = synth_warmup_analysis(
            self.stats, self.config, nq, terms_per_query, seed
        )
        if batch is None:
            return
        slot_h, coeff, rows_g, found_g = batch
        self._collect(self._dispatch(slot_h, coeff, k, rows_g, found_g))

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

    def _segment_inputs(self, slot_h, coeff, rows_g, found_g):
        """Per segment (si, host, rows, found, a_seg) for a batch."""
        seg_global = self._seg_rows_global()
        for si, (host, _dev) in enumerate(self.segments):
            if rows_g is not None and seg_global[si]:
                rows, found = rows_g, found_g
            else:
                rows, found = segment_rows(host.term_hash, slot_h)
            a_seg = np.where(found, coeff, F32(0.0)).astype(F32)
            yield si, host, rows, found, a_seg

    def preplan(self, query_batches, k: int = 10) -> None:
        """Host-only: converge the plan-layout cache over representative
        query batches before the first dispatch (pure numpy)."""
        if self.plan_cache is None or not self.segments:
            return
        mode = self.scorer_mode
        self._check_slice(mode, k)
        families = self._families(mode)
        per_key: dict = {}
        for queries in query_batches:
            slot_h, coeff, rows_g, found_g = self.frontend.analyze_rows(
                queries, self.stats
            )
            n_slots = slot_h.shape[1]
            slot_h, coeff = slice_active_slots(slot_h, coeff)
            nq, s = coeff.shape
            if s != n_slots:
                rows_g, found_g = rows_g[:, :s], found_g[:, :s]
            for si, host, rows, found, _a in self._segment_inputs(
                slot_h, coeff, rows_g, found_g
            ):
                natural = plan_batch(
                    host.indptr, rows, found, families=families,
                    min_blocks=self.plan_min_blocks,
                    compact=(mode == "fused"),
                )
                key = self._plan_key(si, host, s, k, mode, families)
                ent = per_key.setdefault(key, [0, []])
                ent[0] = max(ent[0], nq)
                ent[1].append(natural)
        for key, (nq, naturals) in per_key.items():
            self.plan_cache.seed_plans(key, naturals, nq)

    def _dispatch(self, slot_h, coeff, k: int, rows_g=None, found_g=None):
        """Host planning + the device work of one query batch. Host work:
        slot->row lookup per segment (skipped where the segment's term
        table is the global vocabulary), bucketing, and one stacked
        (rows, coefficient bits) array pair; those are the only
        host->device copies. Returns the in-flight device output plus
        assembly metadata, so callers can pipeline batches."""
        mode = self.scorer_mode
        self._check_slice(mode, k)
        n_slots = slot_h.shape[1]
        slot_h, coeff = slice_active_slots(slot_h, coeff)
        nq, s = coeff.shape
        if rows_g is not None and s != n_slots:
            rows_g, found_g = rows_g[:, :s], found_g[:, :s]
        sc = self.config.scoring
        scale = float(F32(2.0**sc.scale_bits))
        clip = float(
            F32(int(spec.quant_clip_max(self.config.max_query_terms)))
        )
        families = self._families(mode)
        plan = []  # per seg (n_docs, s, ((nb, blk, bq, rc), ...))
        idx_map = []  # per segment: list of (query indices, bq)
        r_subs, a_subs = [], []
        for si, host, rows, found, a_seg in self._segment_inputs(
            slot_h, coeff, rows_g, found_g
        ):
            natural = plan_batch(
                host.indptr, rows, found, families=families,
                min_blocks=self.plan_min_blocks, compact=(mode == "fused"),
            )
            if self.plan_cache is not None:
                key = self._plan_key(si, host, s, k, mode, families)
                cells = self.plan_cache.canonicalize(key, natural, nq)
            else:
                cells = [
                    (idx, nb, blk, rc, _pow2_at_least(len(idx)))
                    for idx, nb, blk, rc in natural
                ]
            buckets, idxs = [], []
            for idx, n_blocks, block, r_c, bq in cells:
                r_sub = np.zeros((bq, s), np.int32)
                a_sub = np.zeros((bq, s), F32)
                r_sub[: len(idx)] = rows[idx]
                a_sub[: len(idx)] = a_seg[idx]
                r_subs.append(r_sub)
                a_subs.append(a_sub)
                buckets.append((n_blocks, block, bq, r_c))
                idxs.append((idx, bq))
            plan.append((host.n_docs, s, tuple(buckets)))
            idx_map.append(idxs)
        # readback trim: the real (non-pad) output rows are gathered on
        # the device before the single device->host read; the gather
        # index rides in rows_cat's tail
        offs = []
        off = 0
        for idxs in idx_map:
            for idx, bq in idxs:
                offs.append(off + np.arange(len(idx), dtype=np.int32))
                off += bq
        idx_flat = np.concatenate(offs)
        n_real = len(idx_flat)
        r_all = np.concatenate(r_subs, axis=0)
        n_extra = -(-n_real // s)
        tail = np.zeros(n_extra * s, np.int32)
        tail[:n_real] = idx_flat
        r_all = np.concatenate([r_all, tail.reshape(n_extra, s)], axis=0)
        dev = self.device
        out = _batch_step(
            [(h.n_docs, h.doc_base, d) for h, d in self.segments],
            torch.from_numpy(r_all).to(dev),
            torch.from_numpy(np.concatenate(a_subs, axis=0).view(np.int32)).to(
                dev
            ),
            plan=plan,
            k=k,
            scale=scale,
            clip=clip,
            mode=mode,
            n_real=n_real,
        )
        return out, idx_map, nq, k

    def _collect(self, fut):
        """Force the device->host read of a dispatched batch and
        assemble (ids, scores); across segments the per-segment top-k
        merge by (score desc, gid asc) on the host."""
        out, idx_map, nq, k = fut
        host = out.cpu().numpy()
        all_vals, all_gids = [], []
        off = 0  # rows are the gathered REAL rows, bq pad dropped
        for idxs in idx_map:
            seg_v = np.full((nq, k), -1, np.int32)
            seg_g = np.full((nq, k), -1, np.int32)
            for idx, _bq in idxs:
                seg_v[idx] = host[off : off + len(idx), :k]
                seg_g[idx] = host[off : off + len(idx), k:]
                off += len(idx)
            all_vals.append(seg_v)
            all_gids.append(seg_g)
        if len(all_vals) == 1:
            v, g = all_vals[0], all_gids[0]
        else:
            vc = np.concatenate(all_vals, axis=1)
            gc = np.concatenate(all_gids, axis=1)
            # (score desc, gid asc); dead (-1,-1) rows sink
            order = np.lexsort((gc, -vc.astype(np.int64)), axis=-1)[:, :k]
            v = np.take_along_axis(vc, order, axis=1)
            g = np.take_along_axis(gc, order, axis=1)
            g = np.where(v > 0, g, -1)
            v = np.where(v > 0, v, -1)
        return g.astype(np.int64), v.astype(np.int64)
