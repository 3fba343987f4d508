"""SearchEngine over torch device segments: build -> search_stream.

Port of `document_search_engine_tpu/engine/engine.py`: build,
add_docs, the streaming build, delete_docs, compact and the auto-compact
policy, the stats and value refresh, save/load (index/checkpoint.py),
search, search_stream, preplan and warmup, with the batch step
(`_batch_step`) running every (segment x bucket) sub-call of a batch and
producing one stacked int32 output, so a batch costs one device->host
read.

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
embeddings, dv planes, doc-quantile tables), so no cache keeps a
replaced plane resident.
"""
from __future__ import annotations

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
from ..oracle import spec
from .query import QueryFrontend, segment_rows

F32 = np.float32
SCORER_MODES = ("fused", "fused_dv", "xla", "xla_rank")
SCORER_ALIASES = {"plain": "xla"}


def _pow2_at_least(n: int, lo: int = 1) -> int:
    n = max(n, lo)
    return 1 << int(np.ceil(np.log2(n)))


def _batch_step(
    segments,  # list of (n_docs, doc_base, SegmentDevice)
    rows_cat: torch.Tensor,  # (sum of bucket bq + tail, S) i32 term rows
    cbits_cat: torch.Tensor,  # (sum of bucket bq, S) i32 coefficient bits
    plan,  # per segment (n_docs, s, ((n_blocks, block, bq, r_c), ...))
    k: int,
    scale: float,
    clip: float,
    mode: str,  # "fused" | "fused_dv" | "xla" | "xla_rank"
    n_real: int,  # readback-trim gather size
    dv_planes=None,  # per segment (X+8, 256) dv plane ("fused_dv")
    cols_cat=None,  # (sum of bucket bq, 2) i32 piece columns (split)
    offs_devs=None,  # per segment (T, P+1) i32 doc-quantile tables
    split_p: int = 0,  # quantile columns P (0 = splitting off)
):
    """The device work of one batch: per (segment x bucket) the plan
    tables expand on the device from the shipped (bq, S) rows and
    coefficient bits, the scorer runs, and the gid mask
    where(v > 0, dloc + doc_base, -1) applies. Returns ONE (n_real, 2k)
    int32 tensor — per-bucket [vals | gids] stacked in plan order, with
    the pow-2 bq padding rows dropped by a gather whose indices ride in
    rows_cat's tail (the same host->device copy).

    With split_p, plan rows are doc-range pieces: their record ranges
    come from the resident quantile tables and the kernel limits each
    piece to docs [cols[0] * n_docs // P, cols[1] * n_docs // P)."""
    from ..ops.fused import expand_plan_tables, fused_search, key_bits_for
    from ..ops.fused_dv import fused_search_dv
    from ..ops.packed import pack_tables, search_packed_tables
    from ..ops.rank import rank_candidates_kernel

    out_v, out_g = [], []
    off = 0
    for si, ((n_docs, doc_base, dev_seg), (_nd, s, buckets)) in enumerate(
        zip(segments, plan)
    ):
        for n_blocks, block, bq, r_c in buckets:
            rows_b = rows_cat[off : off + bq]
            cbits_b = cbits_cat[off : off + bq]
            cols_b = dlim = None
            if split_p:
                cols_b = cols_cat[off : off + bq]
                dlim = (
                    (cols_b.long() * n_docs) // split_p
                ).to(torch.int32).reshape(bq, 1, 2)
            off += bq
            sr, rm, ab, dst = expand_plan_tables(
                dev_seg.row_start, dev_seg.indptr, rows_b, cbits_b,
                n_blocks, block,
                offs_dev=offs_devs[si] if split_p else None, cols=cols_b,
            )
            # the kernels serve k <= MAX_K (128); larger k takes the plain
            # scorer, as the reference takes its XLA twin: by k alone
            if mode in ("fused", "fused_dv") and k <= MAX_K:
                kw = dict(
                    n_blocks=n_blocks, block=block, s=s, k=k,
                    n_docs=n_docs, scale=scale, clip=clip, r_c=r_c,
                    key_bits=key_bits_for(s, n_docs),
                )
                if mode == "fused_dv":
                    v, dloc = fused_search_dv(
                        dv_planes[si], sr, rm, ab, dst, **kw
                    )
                else:
                    v, dloc = fused_search(
                        dev_seg.post_doc, dev_seg.post_val, sr, rm, ab, dst,
                        dlim=dlim, **kw,
                    )
                g = torch.where(v > 0, dloc + doc_base, torch.full_like(v, -1))
            elif mode == "xla_rank" and k <= MAX_K:
                # the plain pack, then the rank-only kernel
                d_key, ci = pack_tables(
                    dev_seg.post_doc, dev_seg.post_val, sr, rm, ab, scale,
                    clip, n_blocks, block, n_docs,
                )
                v, g = rank_candidates_kernel(
                    d_key, ci, doc_base, block=block, s=s, k=k, n_docs=n_docs
                )
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


class SearchEngine:
    """Single-process engine over one or more CSR segments on one torch
    device. `device=None` means "cuda": on a machine without CUDA it
    raises instead of running elsewhere; the CPU is asked for by name."""

    def __init__(self, config: IndexConfig | None = None, device=None):
        self.config = config or IndexConfig()
        self.device = torch.device("cuda" if device is None else device)
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
        # None = "fused" on CUDA, "xla" on the CPU (scorer_mode)
        self.scorer: str | None = None
        # segment lifecycle policy (the reference's): compact when the
        # segment count passes auto_compact_segments, or when tombstoned
        # docs' postings pass auto_compact_dead_frac of all postings;
        # None turns that check off (_maybe_auto_compact)
        self.auto_compact_segments: int | None = 4
        self.auto_compact_dead_frac: float | None = 0.5
        # None = scorer-tuned block families (ops/schedule.py)
        self.block_families = None
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
        self._append_segment(texts)
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
                self._append_segment(batch)
        self._refresh_stats_and_vals()
        self._maybe_auto_compact()

    def _append_segment(self, texts) -> None:
        """Analyze and build one segment on the device, with its doc ids
        following the engine's last."""
        analyzed = builder.analyze_texts_fast(texts, self.config)
        host, dev_seg = builder.build_segment_device(
            analyzed, self.config, self.device, doc_base=self.n_docs_total
        )
        self.segments.append([host, dev_seg])
        self.n_docs_total += host.n_docs

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
        slices. The merged docs are built on the device like any
        segment, with the planes in (row, doc) order."""
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
        host, dev_seg = builder.build_segment_device(
            analyzed, self.config, self.device, doc_base=0
        )
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

    def search_rerank(self, queries, k: int = 10, dim: int = 256,
                      candidates: int = 64):
        """Hybrid retrieval: lexical candidate generation (top
        max(k, candidates)), then a dense feature-hash rerank whose
        candidate gather and exact integer dots run on the device
        (ops/rerank.py gather_and_dot); only the f64 cosine and the
        quantized ordering run on the host, from exact integers.
        Returns (ids, rerank_scores_int, lexical_scores_int) int64
        (nq, k), ranked (rerank desc, lexical desc, gid asc)."""
        from ..ops import rerank as R

        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        kk = max(k, candidates)
        nq = len(queries)
        if nq == 0 or self.n_docs_total == 0 or not self.segments:
            gids, lex = self.search(queries, k=kk)
            return gids[:, :k], np.full((nq, k), -1, np.int64), lex[:, :k]
        # one frontend pass feeds both stages
        slot_h, coeff, rows_g, found_g = self.frontend.analyze_rows(
            queries, self.stats
        )
        gids, lex = self._collect(
            self._dispatch(slot_h, coeff, kk, rows_g, found_g)
        )
        qemb, ssq_q = R.query_embeddings_int(slot_h, coeff, dim)
        emb, ssq = self._device_embeddings(dim)
        dev = self.device
        dots, cand_ssq = R.gather_and_dot(
            emb, ssq, torch.from_numpy(qemb).to(dev),
            torch.from_numpy(gids.astype(np.int32)).to(dev),
        )
        return R.rerank_order_int(
            dots.cpu().numpy(), ssq_q, cand_ssq.cpu().numpy(), lex, gids, k
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
    @property
    def scorer_mode(self) -> str:
        """Active scorer: "fused" (the CUDA kernel; default on CUDA),
        "fused_dv" (the same kernel over interleaved doc|value planes),
        "xla" (the plain PyTorch scorer; default on the CPU; "plain" is
        its alias) or "xla_rank" (the plain pack and the rank-only
        kernel). All are bit-identical."""
        if self.scorer is not None:
            mode = SCORER_ALIASES.get(self.scorer, self.scorer)
            if mode not in SCORER_MODES:
                raise ValueError(f"unknown scorer {self.scorer!r}")
            return mode
        return "fused" if self.device.type == "cuda" else "xla"

    def _mode_for(self, k: int) -> str:
        """The scorer mode serving k: "fused_dv" is downgraded to
        "fused" for k > 128, which the plain scorer serves over the
        standard planes (the reference's dispatcher does the same)."""
        mode = self.scorer_mode
        return "fused" if mode == "fused_dv" and k > MAX_K else mode

    def _families(self, mode: str):
        return self.block_families or (
            FUSED_FAMILIES if mode.startswith("fused") else DEFAULT_FAMILIES
        )

    def _check_request(self, k: int) -> None:
        """Raise on an unknown scorer name or k < 1."""
        self.scorer_mode  # noqa: B018 — validates the scorer name
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")

    def search(self, queries, k: int = 10):
        """Batched search: (ids, scores) int64 arrays of shape (nq, k),
        ranked by (fixed-point score desc, global doc id asc)."""
        self._check_request(k)
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
        self._check_request(k)

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
        self._check_request(k)
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

    def _doc_quantiles(self, si: int, host, dev_seg):
        """(offs_h, offs_d): the segment's (T, P+1) int32 doc-quantile
        table for doc-range splitting, on the host for the planner and
        on the device for the plan expansion. Built on the device from
        the resident doc plane (builder.device_row_doc_quantiles; the
        port keeps no host postings) and cached per segment while its
        doc plane is the same tensor (every mutation drops the cache)."""
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

    def _split_active(self, mode: str, k: int, families) -> bool:
        """Splitting serves only the fused scorer with one block family
        (ops/schedule.py split_pieces), for k the kernel serves."""
        return (
            self.split_rows is not None
            and mode == "fused"
            and k <= MAX_K
            and len(families) == 1
        )

    def _segment_plan(self, si, host, dev_seg, rows, found, a_seg,
                      families, mode, k):
        """Shared by preplan and _dispatch: the segment's natural plan
        and, when splitting, its piece table. Returns (rows_p, a_p, cols,
        qidx, pno, natural); cols/qidx/pno are None when the plan rows
        are the queries themselves."""
        compact = mode.startswith("fused") and k <= MAX_K
        # empty segments have no quantile table (T = 0) and nothing to
        # split; they take the unsplit plan (zero blocks either way)
        if not self._split_active(mode, k, families) or len(host.indptr) < 2:
            natural = plan_batch(
                host.indptr, rows, found, families=families,
                min_blocks=self.plan_min_blocks, compact=compact,
            )
            return rows, a_seg, None, None, None, natural
        offs_h, _offs_d = self._doc_quantiles(si, host, dev_seg)
        lens = (host.indptr[rows + 1] - host.indptr[rows]) * found
        qidx, pno, cols, lens_p = split_pieces(
            lens, rows, offs_h, self.split_rows, families[0][1],
            builder.SPLIT_QUANTILES,
        )
        natural = plan_batch(
            host.indptr, rows[qidx], found[qidx], families=families,
            min_blocks=self.plan_min_blocks, compact=compact, lens=lens_p,
        )
        return rows[qidx], a_seg[qidx], cols, qidx, pno, natural

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

    def preplan(self, query_batches, k: int = 10) -> None:
        """Host-only: converge the plan-layout cache over representative
        query batches before the first dispatch (numpy planning; with
        splitting on, the quantile tables are built once first)."""
        if self.plan_cache is None or not self.segments:
            return
        mode = self._mode_for(k)
        self._check_request(k)
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
            for si, host, rows, found, a_seg in self._segment_inputs(
                slot_h, coeff, rows_g, found_g
            ):
                rows_p, _a, _cols, _qidx, _pno, natural = self._segment_plan(
                    si, host, self.segments[si][1], rows, found, a_seg,
                    families, mode, k,
                )
                key = self._plan_key(si, host, s, k, mode, families)
                ent = per_key.setdefault(key, [0, []])
                ent[0] = max(ent[0], rows_p.shape[0])
                ent[1].append(natural)
        for key, (nq, naturals) in per_key.items():
            self.plan_cache.seed_plans(key, naturals, nq)

    def _dispatch(self, slot_h, coeff, k: int, rows_g=None, found_g=None):
        """Host planning + the device work of one query batch. Host work:
        slot->row lookup per segment (skipped where the segment's term
        table is the global vocabulary), splitting into doc-range pieces
        when on, bucketing, and one stacked (rows, coefficient bits)
        array pair (plus the pieces' quantile columns); those are the
        only host->device copies. Returns the in-flight device output
        plus assembly metadata, so callers can pipeline batches."""
        mode = self._mode_for(k)
        self._check_request(k)
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
        split = self._split_active(mode, k, families)
        p = builder.SPLIT_QUANTILES
        plan = []  # per seg (n_docs, s, ((nb, blk, bq, rc), ...))
        idx_map = []  # per segment: list of (plan-row indices, bq)
        piece_maps = []  # per segment: None | (qidx, pno, mmax, n_rows_p)
        r_subs, a_subs, c_subs = [], [], []
        for si, host, rows, found, a_seg in self._segment_inputs(
            slot_h, coeff, rows_g, found_g
        ):
            rows_p, a_p, cols, qidx, pno, natural = self._segment_plan(
                si, host, self.segments[si][1], rows, found, a_seg,
                families, mode, k,
            )
            n_rows_p = rows_p.shape[0]
            if self.plan_cache is not None:
                key = self._plan_key(si, host, s, k, mode, families)
                cells = self.plan_cache.canonicalize(key, natural, n_rows_p)
            else:
                cells = [
                    (idx, nb, blk, rc, _pow2_at_least(len(idx)))
                    for idx, nb, blk, rc in natural
                ]
            buckets, idxs = [], []
            for idx, n_blocks, block, r_c, bq in cells:
                r_sub = np.zeros((bq, s), np.int32)
                a_sub = np.zeros((bq, s), F32)
                r_sub[: len(idx)] = rows_p[idx]
                a_sub[: len(idx)] = a_p[idx]
                r_subs.append(r_sub)
                a_subs.append(a_sub)
                if split:
                    # padding rows and unsplit (empty) segments take the
                    # whole-row piece (0, P): cols stay aligned with the
                    # bucket offsets across all segments
                    c_sub = np.zeros((bq, 2), np.int32)
                    c_sub[:, 1] = p
                    if cols is not None:
                        c_sub[: len(idx)] = cols[idx]
                    c_subs.append(c_sub)
                buckets.append((n_blocks, block, bq, r_c))
                idxs.append((idx, bq))
            plan.append((host.n_docs, s, tuple(buckets)))
            idx_map.append(idxs)
            piece_maps.append(
                None if cols is None
                else (qidx, pno, int(pno.max()) + 1 if len(pno) else 1,
                      n_rows_p)
            )
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
        split_kw = {}
        if split:
            split_kw = dict(
                cols_cat=torch.from_numpy(np.concatenate(c_subs)).to(dev),
                offs_devs=[
                    self._doc_quantiles(si, h, d)[1]
                    for si, (h, d) in enumerate(self.segments)
                ],
                split_p=p,
            )
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
            dv_planes=self._dv_planes() if mode == "fused_dv" else None,
            **split_kw,
        )
        return out, idx_map, piece_maps, nq, k

    def _collect(self, fut):
        """Force the device->host read of a dispatched batch and
        assemble (ids, scores): a split query's doc-disjoint pieces, and
        then the segments, merge by (score desc, gid asc) on the host."""
        out, idx_map, piece_maps, nq, k = fut
        host = out.cpu().numpy()
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
            if pm is not None and pm[2] > 1:
                # pieces are doc-disjoint, so the merge of their top-ks
                # is the unsplit ranking (as for segments below)
                qidx, pno, mmax, _n = pm
                pv = np.full((nq, mmax, k), -1, np.int32)
                pg = np.full((nq, mmax, k), -1, np.int32)
                pv[qidx, pno] = seg_v
                pg[qidx, pno] = seg_g
                seg_v, seg_g = _merge_ranked(
                    pv.reshape(nq, mmax * k), pg.reshape(nq, mmax * k), k
                )
            all_vals.append(seg_v)
            all_gids.append(seg_g)
        if len(all_vals) == 1:
            v, g = all_vals[0], all_gids[0]
        else:
            v, g = _merge_ranked(
                np.concatenate(all_vals, axis=1),
                np.concatenate(all_gids, axis=1), k,
            )
        return g[:nq].astype(np.int64), v[:nq].astype(np.int64)


def _merge_ranked(vc: np.ndarray, gc: np.ndarray, k: int):
    """Top k of each row of (vals, gids) by (score desc, gid asc); dead
    (-1, -1) entries sink and come out as (-1, -1)."""
    order = np.lexsort((gc, -vc.astype(np.int64)), axis=-1)[:, :k]
    v = np.take_along_axis(vc, order, axis=1)
    g = np.take_along_axis(gc, order, axis=1)
    return np.where(v > 0, v, -1), np.where(v > 0, g, -1)
