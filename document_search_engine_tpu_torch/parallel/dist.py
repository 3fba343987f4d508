"""Document-sharded index and search over a `docs` mesh of torch devices.

Port of `document_search_engine_tpu/parallel/dist.py`, with its names
and in its order. Each shard owns a contiguous global doc-id range and
holds its own aligned posting planes, padded to shapes every shard
shares. Rows are indexed by the CORPUS-GLOBAL sorted vocabulary: a term
absent from a shard has row length 0 there (it occupies no aligned
record). So a batch costs one host vocab lookup, one (rows, coefficient
bits) table shipped once to each distinct device of the mesh, and per
shard the plan tables expand on its device from its resident global-row
indptr/row_start tables.

Where the reference runs one shard_map program, one process here loops
over the shards (parallel/mesh.py): shard i's tensors live on
`mesh.devices[i]`, and the reference's two collectives are
`mesh.all_gather` (the candidates of a batch, then one merge on the
mesh's first device, ops/topk.py) and `mesh.psum` (the build's df and
the rerank's integer dots). The engine serves through the path it
shares with SearchEngine (engine/engine.py ServingEngine: the request
check, search, search_stream, search_rerank, warmup, preplan's loop;
fill_buckets; merge_pieces): it supplies its planning over the shards,
`_dispatch` and `_collect`. A search step, per shard and bucket, is the
single engine's route (engine.py route_bucket: plan expansion, the
scorer with a doc-range limit when splitting, the gid mask); then the
gather and merge. The scorers see the fleet-uniform sentinel n_docs =
d_pad - 1, which lies past every shard's real local ids. Scores are
integer fixed point, so rankings are bit-identical for every shard
count.

The sharded build (device_build, the default) packs every shard on its
device through index/builder.py's chunked device build: sort the
(global row, local doc, tf) triples, scatter the aligned planes,
materialize the values (its FMA-free arithmetic and its +0.0 padding
select), count the local df, and psum it. The host build (device_build=False) packs each shard's CSR on the
host and assembles the planes there (assemble_sharded), as checkpoint
loads, reshards and compactions do. The two pad the doc plane
differently, as in the reference: the SPMD build with d_pad - 1, the
host assembly with the shard's own n_docs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from ..config import IndexConfig
from ..engine.engine import (
    ServingEngine,
    active_slots,
    delete_from_hosts,
    fill_buckets,
    merge_pieces,
    piece_map,
    route_bucket,
)
from ..engine.step_graph import (
    dispatch_span,
    resident_key,
    run_step,
    step_key,
)
from ..index import builder
from ..index.csr import GlobalStats, merge_stats, round_up
from ..ops.fused import MAX_K
from ..ops.schedule import plan_batch_sharded, split_pieces_sharded
from ..ops.topk import merge_candidates
from .mesh import Mesh, all_gather, make_mesh, psum

F32 = np.float32


def _put(a: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`: to a card from pinned memory, without
    waiting on it (the caching host allocator keeps the pinned block
    until the copy has run); on the CPU the array itself."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _replicate(a: np.ndarray, mesh: Mesh) -> dict:
    """One copy of a host array on each distinct device of the mesh."""
    return {dev: _put(a, dev) for dev in mesh.distinct}


@dataclass
class ShardedIndex:
    """Per-shard aligned posting planes and tables: list entry i is shard
    i's tensor, on the mesh's devices[i] (see index/csr.py SegmentDevice
    for the plane layout)."""

    post_doc: list  # per shard (X, 128) i32
    post_val: list  # per shard (X, 128) i32 bitcast f32
    # raw tfs in the same geometry: refreshes re-materialize the values
    # on the device
    post_tf: list  # per shard (X, 128) i32
    alive: list  # per shard (d_pad,) bool
    doc_base: list  # per shard int: global id of local doc 0
    # per-shard CSR lookup tables in the GLOBAL row space (module
    # docstring): indptr_g[i][r+1] - indptr_g[i][r] is shard i's postings
    # count for global term row r (0 when absent), row_start_d[i][r] its
    # aligned flat start in shard i's planes. Host copy for bucket
    # planning, per-shard device copies for the plan expansion.
    indptr_g: np.ndarray  # host (n_shards, t_pad+1) i32
    indptr_d: list  # per shard (t_pad+1,) i32
    row_start_d: list  # per shard (t_pad,) i32
    hosts: list  # per-shard SegmentHost (numpy metadata)
    stats: GlobalStats
    n_shards: int
    d_pad: int
    t_pad: int  # padded GLOBAL vocab size (sizes incremental updates)
    # the SPMD build's psum'd global df (None for host assembly); tests
    # pin it equal to the host stats merge
    df_psum: np.ndarray | None = field(default=None, repr=False)

    @property
    def x_rows(self) -> int:
        return int(self.post_doc[0].shape[0])

    def nbytes(self) -> int:
        """Device bytes of every shard's planes and tables."""
        return sum(
            t.numel() * t.element_size()
            for ts in (self.post_doc, self.post_val, self.post_tf,
                       self.alive, self.indptr_d, self.row_start_d)
            for t in ts
        )


def _ensure_host_csr(h) -> None:
    """Device-built shards keep no host postings copies; re-derive them
    from the analyzed docs when a host-side reassembly needs them (the
    same lexsort as the original pack, so bit-identical)."""
    if h.post_doc is not None:
        return
    a = builder.AnalyzedDocs(
        hashes=h.doc_hashes, tfs=h.doc_tfs, doc_ptr=h.doc_ptr, dl=h.dl
    )
    nh = builder.build_host_segment(a, h.doc_base)
    h.indptr = nh.indptr
    h.post_doc = nh.post_doc
    h.post_tf = nh.post_tf


def _global_t_pad(stats: GlobalStats) -> int:
    """Padded global vocab size: ~25% growth headroom so incremental
    adds that introduce new terms fit without a shape change."""
    tg = len(stats.vocab)
    return round_up(tg + max(tg // 4, 64), 64)


def _global_tables_one(h, stats: GlobalStats, t_pad: int):
    """One shard's (indptr_g, row_start_g) in the global row space."""
    lens_g = np.zeros(t_pad, np.int64)
    rs = np.zeros(t_pad, np.int64)
    if h.n_terms:
        gmap = np.searchsorted(stats.vocab, h.term_hash)
        lens_g[gmap] = np.diff(h.indptr)
        rs[gmap] = h.row_start
    ip = np.zeros(t_pad + 1, np.int64)
    np.cumsum(lens_g, out=ip[1:])
    return ip.astype(np.int32), rs.astype(np.int32)


def _global_tables(hosts, stats: GlobalStats, t_pad: int):
    n_shards = len(hosts)
    ipg = np.zeros((n_shards, t_pad + 1), np.int32)
    rsg = np.zeros((n_shards, t_pad), np.int32)
    for i, h in enumerate(hosts):
        ipg[i], rsg[i] = _global_tables_one(h, stats, t_pad)
    return ipg, rsg


def _check_mesh(hosts, mesh: Mesh) -> None:
    if len(hosts) != mesh.size:
        raise ValueError(f"{len(hosts)} shards for a mesh of {mesh.size}")


def assemble_sharded(hosts, config: IndexConfig, mesh: Mesh) -> ShardedIndex:
    """Pack per-shard host metadata into padded per-shard device planes
    with corpus-global stats: the host build, checkpoint load and
    reshard, compaction and the incremental fallback (the device planes
    are fully derivable from SegmentHost)."""
    _check_mesh(hosts, mesh)
    for h in hosts:
        _ensure_host_csr(h)
    n_shards = len(hosts)
    stats = merge_stats(hosts)
    t_pad = _global_t_pad(stats)
    # ~12.5% postings growth headroom so small incremental adds fit the
    # padded shapes and take the O(delta) last-shard update instead of a
    # full reassembly (_update_last_shard)
    d_pad = round_up(max(h.n_docs for h in hosts) + 1, config.docs_pad_to)
    geoms = [
        builder.aligned_geometry(h.indptr, config.nnz_pad_to)
        for h in hosts
    ]
    x_rows = max(x for _, x in geoms)
    x_rows = x_rows + max(x_rows // 8, 8)

    pd, pv, pt, al = [], [], [], []
    for i, (h, (row_start, _xr)) in enumerate(zip(hosts, geoms)):
        dev = mesh.devices[i]
        h.row_start = row_start
        vals, _inv_norm = builder.segment_vals(h, config, stats)
        d2, v2, t2 = builder._host_planes(
            h.post_doc, vals, h.post_tf, h.indptr, row_start, x_rows,
            h.n_docs,
        )
        pd.append(_put(d2, dev))
        pv.append(_put(v2, dev))
        pt.append(_put(t2, dev))
        al.append(_put(builder._pad(h.alive, d_pad, False, bool), dev))

    ipg, rsg = _global_tables(hosts, stats, t_pad)
    return ShardedIndex(
        post_doc=pd,
        post_val=pv,
        post_tf=pt,
        alive=al,
        doc_base=[int(h.doc_base) for h in hosts],
        indptr_g=ipg,
        indptr_d=[_put(ipg[i], d) for i, d in enumerate(mesh.devices)],
        row_start_d=[_put(rsg[i], d) for i, d in enumerate(mesh.devices)],
        hosts=hosts,
        stats=stats,
        n_shards=n_shards,
        d_pad=d_pad,
        t_pad=t_pad,
    )


def _materialize_plane(pd, pt, kd, inv, al, k1p1: float, kind: str):
    """The value-materialization body: builder.device_materialize_vals,
    whose ops hold no mul->add pair (no FMA) and whose padding goes
    through an explicit select (bm25 padding is 0/0 = NaN; the stored
    bits must be +0.0)."""
    return builder.device_materialize_vals(
        pd, pt, kd, inv, al,
        torch.tensor(F32(k1p1), device=pd.device), kind=kind,
    )


def build_sharded(
    texts, config: IndexConfig, mesh: Mesh, device_build: bool = True
) -> ShardedIndex:
    """Build a document-sharded index: contiguous doc ranges per shard,
    corpus-global vocabulary and df, shapes shared by every shard.
    device_build (default): build_sharded_spmd, the planes packed on the
    shards' devices and the global df by psum. Otherwise the host build
    (build_host_segment per shard, then assemble_sharded)."""
    texts = list(texts)
    if device_build:
        return build_sharded_spmd(texts, config, mesh)
    n_shards = mesh.size
    n_docs = len(texts)
    per = -(-n_docs // n_shards) if n_docs else 1
    hosts = []
    for i in range(n_shards):
        lo, hi = min(i * per, n_docs), min((i + 1) * per, n_docs)
        a = builder.analyze_texts_fast(texts[lo:hi], config)
        hosts.append(builder.build_host_segment(a, lo))
    return assemble_sharded(hosts, config, mesh)


def _spmd_build_step(
    triples,  # iterator, per shard in turn: ((nnz_i,) i32 GLOBAL term
    #           rows, local doc ids, tfs) on its device
    indptr_g,  # per shard (t_pad+1,) i32
    row_start_g,  # per shard (t_pad,) i32
    k_doc,  # per shard (d_pad,) f32
    inv_norm,  # per shard (d_pad,) f32
    alive,  # per shard (d_pad,) bool
    k1p1: float,
    x_rows: int,
    t_pad: int,
    d_pad: int,
    kind: str,
    mesh_: Mesh,
):
    """The sharded build's device work, per shard on its device, through
    the single engine's chunked build: builder.device_pack sorts the
    (row, doc, tf) triples over the t_pad global rows (its df is the
    shard's local df), builder.device_align_planes scatters them into
    the aligned (X, 128) doc/tf planes through the shard's global-row
    tables with the padding d_pad - 1, and the value plane is
    materialized; then ONE psum over the shards gives the corpus-global
    df (tests pin it equal to the host vocab-union merge). `triples` is
    an iterator, so a shard's triples need exist only while it is
    packed: they are taken with next(), because zip and enumerate keep
    their last item alive. Returns (doc planes, tf planes, value planes,
    global df (t_pad,) i32 on the mesh's first device)."""
    pds, pts, pvs, dfs = [], [], [], []
    for i in range(mesh_.size):
        r, d, t = next(triples)
        r, d, t, _ip, df, _dl = builder.device_pack(
            r, d, t, n_terms=t_pad, n_docs=d_pad
        )
        doc2, tf2 = builder.device_align_planes(
            r, d, t, indptr_g[i], row_start_g[i], x_rows=x_rows,
            n_docs=d_pad - 1,
        )
        del r, d, t
        dfs.append(df)
        pds.append(doc2)
        pts.append(tf2)
        pvs.append(_materialize_plane(doc2, tf2, k_doc[i], inv_norm[i],
                                      alive[i], k1p1, kind))
    df_g = psum(dfs, mesh_.dst)
    return pds, pts, pvs, df_g


def build_sharded_spmd(
    texts, config: IndexConfig, mesh: Mesh
) -> ShardedIndex:
    """The sharded device build: host analysis per contiguous doc range,
    then _build_sharded_from_parts."""
    texts = list(texts)
    n_shards = mesh.size
    n_docs = len(texts)
    per = -(-n_docs // n_shards) if n_docs else 1
    parts = []  # (doc_base, AnalyzedDocs)
    for i in range(n_shards):
        lo, hi = min(i * per, n_docs), min((i + 1) * per, n_docs)
        parts.append((lo, builder.analyze_texts_fast(texts[lo:hi], config)))
    return _build_sharded_from_parts(parts, config, mesh)


def _split_analyzed(a, n_shards: int):
    """Re-split one AnalyzedDocs into contiguous per-shard parts."""
    n_docs = a.n_docs
    per = -(-n_docs // n_shards) if n_docs else 1
    parts = []
    for i in range(n_shards):
        lo, hi = min(i * per, n_docs), min((i + 1) * per, n_docs)
        s, e = int(a.doc_ptr[lo]), int(a.doc_ptr[hi])
        parts.append(
            (
                lo,
                builder.AnalyzedDocs(
                    hashes=a.hashes[s:e],
                    tfs=a.tfs[s:e],
                    doc_ptr=a.doc_ptr[lo : hi + 1] - a.doc_ptr[lo],
                    dl=a.dl[lo:hi],
                ),
            )
        )
    return parts


def _build_sharded_from_parts(parts, config: IndexConfig, mesh: Mesh):
    _check_mesh(parts, mesh)
    # per-shard host metadata with LOCAL vocab (the checkpoint format;
    # postings per term = df since (doc, term) pairs are unique)
    hosts = []
    for lo, a in parts:
        vocab, _rows_l, df_l = builder.segment_vocab(a)
        indptr_l = np.zeros(len(vocab) + 1, np.int32)
        np.cumsum(df_l, out=indptr_l[1:])
        row_start_l, _xr = builder.aligned_geometry(
            indptr_l, config.nnz_pad_to
        )
        hosts.append(
            builder.SegmentHost(
                term_hash=vocab,
                df=df_l,
                doc_base=lo,
                n_docs=a.n_docs,
                dl=a.dl.copy(),
                alive=np.ones(a.n_docs, dtype=bool),
                doc_hashes=a.hashes,
                doc_tfs=a.tfs,
                doc_ptr=a.doc_ptr,
                indptr=indptr_l,
                row_start=row_start_l,
                post_doc=None,  # device-built: the planes live on the device
                post_tf=None,
            )
        )
    stats = merge_stats(hosts)
    t_pad = _global_t_pad(stats)
    d_pad = round_up(max(h.n_docs for h in hosts) + 1, config.docs_pad_to)
    geoms = [
        builder.aligned_geometry(h.indptr, config.nnz_pad_to)
        for h in hosts
    ]
    x_rows = max(x for _, x in geoms)
    x_rows = x_rows + max(x_rows // 8, 8)
    ipg, rsg = _global_tables(hosts, stats, t_pad)

    devs = mesh.devices
    kd_d, inv_d, al_d = [], [], []
    for i, h in enumerate(hosts):
        dev = devs[i]
        k_doc, inv_norm, alive = builder.refresh_inputs(h, config, stats)
        kd_d.append(_put(builder._pad(k_doc, d_pad, 0, F32), dev))
        inv_d.append(_put(builder._pad(inv_norm, d_pad, 0, F32), dev))
        al_d.append(_put(builder._pad(alive, d_pad, False, bool), dev))
    ip_d = [_put(ipg[i], d) for i, d in enumerate(devs)]
    rs_d = [_put(rsg[i], d) for i, d in enumerate(devs)]
    triples = (
        (
            _put(stats.lookup(a.hashes).astype(np.int32), dev),
            _put(np.repeat(np.arange(a.n_docs, dtype=np.int32),
                           np.diff(a.doc_ptr).astype(np.int64)), dev),
            _put(a.tfs.astype(np.int32), dev),
        )
        for (_lo, a), dev in zip(parts, devs)
    )
    pd, pt, pv, df_g = _spmd_build_step(
        triples, ip_d, rs_d, kd_d, inv_d, al_d,
        F32(config.scoring.k1 + 1.0),
        x_rows=x_rows, t_pad=t_pad, d_pad=d_pad, kind=config.scoring.kind,
        mesh_=mesh,
    )
    return ShardedIndex(
        post_doc=pd,
        post_val=pv,
        post_tf=pt,
        alive=al_d,
        doc_base=[int(h.doc_base) for h in hosts],
        indptr_g=ipg,
        indptr_d=ip_d,
        row_start_d=rs_d,
        hosts=hosts,
        stats=stats,
        n_shards=len(hosts),
        d_pad=d_pad,
        t_pad=t_pad,
        df_psum=df_g.cpu().numpy(),
    )


def refresh_sharded_vals(idx: ShardedIndex, config: IndexConfig, mesh: Mesh):
    """Device-side value re-materialization on every shard after df, N
    or avgdl changed: ships only the (d_pad,) k_doc/inv_norm/alive of
    each shard, the O(nnz) planes stay resident. Rebuilds the global-row
    lookup tables only when the global vocabulary changed."""
    old_vocab = idx.stats.vocab
    idx.stats = merge_stats(idx.hosts)
    devs = mesh.devices
    if not np.array_equal(idx.stats.vocab, old_vocab):
        assert len(idx.stats.vocab) <= idx.t_pad, (
            "vocabulary outgrew t_pad: callers must reassemble instead"
        )
        ipg, rsg = _global_tables(idx.hosts, idx.stats, idx.t_pad)
        idx.indptr_g = ipg
        idx.indptr_d = [_put(ipg[i], d) for i, d in enumerate(devs)]
        idx.row_start_d = [_put(rsg[i], d) for i, d in enumerate(devs)]
    d_pad = idx.d_pad
    kd, inv, al = [], [], []
    for i, h in enumerate(idx.hosts):
        k_doc, inv_norm, alive = builder.refresh_inputs(
            h, config, idx.stats
        )
        kd.append(_put(builder._pad(k_doc, d_pad, 0, F32), devs[i]))
        inv.append(_put(builder._pad(inv_norm, d_pad, 0, F32), devs[i]))
        al.append(_put(builder._pad(alive, d_pad, False, bool), devs[i]))
    idx.alive = al
    k1p1 = F32(config.scoring.k1 + 1.0)
    idx.post_val = [
        _materialize_plane(pd, pt, k, v, a, k1p1, config.scoring.kind)
        for pd, pt, k, v, a in zip(idx.post_doc, idx.post_tf, kd, inv, al)
    ]


def _sharded_quantiles(
    post_doc,  # per shard (X, 128) i32 aligned doc planes
    indptr_g,  # per shard (t_pad+1,) i32 global-row tables
    row_start_g,  # per shard (t_pad,) i32
    n_loc,  # per shard int: true LOCAL doc counts
    p: int,
):
    """Per-shard (t_pad, P+1) doc-quantile tables in the global row
    space: each shard binary-searches its resident doc plane against its
    OWN local-doc thresholds j*n_s/P, so piece j of any query covers
    shard-local docs [j*n_s/P, (j+1)*n_s/P) on every shard s. Absent rows
    (zero length in this shard) yield all-zero offsets."""
    out = []
    for pd, ipg, rsg, nl in zip(post_doc, indptr_g, row_start_g, n_loc):
        j = torch.arange(1, p, dtype=torch.int32, device=pd.device)
        # == host quantile_doc_bounds in i32 (callers assert
        # d_pad * P < 2^31, so the i64 host math agrees)
        bounds = (j * int(nl)) // p
        out.append(builder.device_row_doc_quantiles_b(pd, ipg, rsg, bounds))
    return out


def _sharded_batch_step(
    post_doc,  # per shard (X, 128) i32 aligned doc planes
    post_val,  # per shard (X, 128) i32 aligned bitcast-f32 val planes
    doc_base,  # per shard int
    indptr_g,  # per shard (t_pad+1,) i32 global-row tables
    row_start_g,  # per shard (t_pad,) i32
    rows_cat,  # {device: (B_total, S) i32}: replicated, rows are global
    cbits_cat,  # {device: (B_total, S) i32} bitcast-f32 coefficients
    k: int,
    plan,  # (s, ((n_blocks, block, bq, r_c), ...)) bucket layout
    d_pad: int,
    scale: float,
    clip: float,
    mode: str,  # "fused" | "xla" | "xla_rank"
    mesh_: Mesh,
    cols_cat=None,  # {device: (B_total, 2) i32} piece quantile columns
    quant=None,  # per shard (t_pad, P+1) i32 quantile tables
    n_loc=None,  # per shard int: true local doc counts
    split_p: int = 0,  # quantile columns P (0 = splitting off)
):
    """The device work of one batch: per shard, route_bucket per bucket
    on the shard's device over its resident global-row tables, with the
    fleet-uniform sentinel d_pad - 1 (every shard's real local ids are
    <= d_pad - 2); then one all_gather of every shard's candidates onto
    the mesh's first device and one merge give the global top-k. Returns
    ONE (B_total, 2k) int32 tensor [vals | gids], so a batch costs one
    device->host read.

    split_p > 0 (doc-range splitting): plan rows are PIECES covering
    quantile columns [c0, c1); each shard's record ranges come from its
    resident quantile table and its kernel keeps only ITS local docs
    [c0*n_s/P, c1*n_s/P): the piece structure is shared, the doc limits
    are per shard."""
    s, buckets = plan
    shard_v, shard_g = [], []
    for i in range(mesh_.size):
        dev = mesh_.devices[i]
        planes = (post_doc[i], post_val[i], row_start_g[i], indptr_g[i])
        split = (quant[i], n_loc[i], split_p) if split_p else None
        parts_v, parts_g = [], []
        off = 0
        for bucket in buckets:
            v, g = route_bucket(
                planes, rows_cat[dev], cbits_cat[dev],
                cols_cat[dev] if split_p else None, off, bucket, s=s, k=k,
                mode=mode, scale=scale, clip=clip, sentinel=d_pad - 1,
                doc_base=doc_base[i], split=split,
            )
            off += bucket[2]
            parts_v.append(v)
            parts_g.append(g)
        shard_v.append(torch.cat(parts_v, 0))  # (B_total, k)
        shard_g.append(torch.cat(parts_g, 0))
    # the one collective of a batch: every shard's candidates
    vals_g = all_gather(shard_v, mesh_.dst)  # (S, B_total, k)
    gids_g = all_gather(shard_g, mesh_.dst)
    nq = vals_g.shape[1]
    vals_c = vals_g.transpose(0, 1).reshape(nq, -1)
    gids_c = gids_g.transpose(0, 1).reshape(nq, -1)
    mv, mg = merge_candidates(vals_c, gids_c, k=k)
    return torch.cat([mv, mg], dim=1)


def _step_on_device(dev, idx, kw, rows, cbits, cols=None):
    """_sharded_batch_step on a mesh whose shards all sit on `dev`, with
    the batch's inputs given once as tensors there (a graph's static
    inputs)."""
    return _sharded_batch_step(
        idx.post_doc, idx.post_val, idx.doc_base, idx.indptr_d,
        idx.row_start_d, {dev: rows}, {dev: cbits},
        cols_cat=None if cols is None else {dev: cols}, **kw,
    )


def _sharded_gather_dots(
    emb,  # per shard (d_pad, dim) i8
    ssq,  # per shard (d_pad,) i32
    doc_base,  # per shard int
    n_docs_sh,  # per shard int: true docs per shard
    qemb,  # {device: (nq, dim) i8}, replicated
    gids,  # {device: (nq, K) i32} candidate global ids (-1 = dead)
    mesh_: Mesh,
):
    """Sharded candidate rerank dots: each shard dots (the dots kernel,
    ops/rerank.py gather_and_dot) only the candidates whose global id
    falls in its doc range; the others, and dead ids, read its row 0 and
    are zeroed BEFORE the sum, so they contribute exact zeros. Then one
    integer psum gives the full (nq, K) dots and candidate squared norms
    on the mesh's first device. All values are exact integers."""
    from ..ops.rerank import gather_and_dot

    dots_sh, ssq_sh = [], []
    for i in range(mesh_.size):
        dev = mesh_.devices[i]
        g = gids[dev]
        loc = g - doc_base[i]
        mine = (g >= 0) & (loc >= 0) & (loc < n_docs_sh[i])
        safe = torch.where(mine, loc, torch.zeros_like(loc))
        dots, cs = gather_and_dot(emb[i], ssq[i], qemb[dev], safe)
        zero = torch.zeros_like(dots)
        dots_sh.append(torch.where(mine, dots, zero))
        ssq_sh.append(torch.where(mine, cs, zero))
    return psum(dots_sh, mesh_.dst), psum(ssq_sh, mesh_.dst)


class DistributedSearchEngine(ServingEngine):
    """Search engine over a `docs` mesh of torch devices (the same
    results as the single SearchEngine, bit for bit; tested), serving
    through ServingEngine's path (engine/engine.py). mesh None means
    make_mesh(): one shard a card, and without CUDA it raises; the CPU is
    asked for by name (make_mesh(n, device="cpu")). Its scorers are the
    reference sharded engine's: no "fused_dv". With doc-range splitting
    the piece STRUCTURE is shared by every shard (decided from the
    max-over-shards need); record ranges and doc limits are per shard,
    read on the device from resident quantile tables
    (_sharded_quantiles). The step is a CUDA graph when every shard sits
    on one card; a mesh over several cards runs it eagerly."""

    scorer_modes = ("fused", "xla", "xla_rank")
    search_phases = False

    def __init__(self, config: IndexConfig | None = None,
                 mesh: Mesh | None = None):
        self.mesh = mesh or make_mesh()
        dst = self.mesh.dst
        one_card = len(self.mesh.distinct) == 1 and dst.type == "cuda"
        super().__init__(config, dst, dst if one_card else None)
        self.index: ShardedIndex | None = None
        self._drop_caches()

    def _drop_caches(self) -> None:
        """Forget the embedding and quantile tables and the step graphs:
        every mutation calls this, so no cache keeps a replaced plane
        resident."""
        self._emb_cache = None  # (dim, post_val tensors, (emb, ssq))
        self._quant_cache = None  # (post_doc, indptr_d tensors, tables)
        self._last_step = None  # (step, host inputs) of the last batch
        if self._graphs is not None:
            self._graphs.clear()

    def _set_index(self, index: ShardedIndex | None) -> None:
        self.index = index
        self._drop_caches()

    def build(self, texts) -> None:
        self._set_index(build_sharded(
            texts, self.config, self.mesh, device_build=self.device_build
        ))

    def build_streaming(self, batches) -> None:
        """Streaming sharded build: raw text is analyzed and released
        batch by batch (the analyzed (hash, tf) arrays are ~10x smaller),
        then the docs are balanced into contiguous shard ranges and
        packed by the device build. Bit-identical to the bulk build
        (tested)."""
        analyzed = []
        for b in batches:
            b = list(b)
            if b:
                analyzed.append(builder.analyze_texts_fast(b, self.config))
        if not analyzed:
            self._set_index(None)
            return
        ptr_parts = [np.zeros(1, np.int64)]
        acc = 0
        for a in analyzed:
            ptr_parts.append(a.doc_ptr[1:] + acc)
            acc += int(a.doc_ptr[-1])
        merged = builder.AnalyzedDocs(
            hashes=np.concatenate([a.hashes for a in analyzed]),
            tfs=np.concatenate([a.tfs for a in analyzed]),
            doc_ptr=np.concatenate(ptr_parts),
            dl=np.concatenate([a.dl for a in analyzed]),
        )
        self._set_index(_build_sharded_from_parts(
            _split_analyzed(merged, self.mesh.size), self.config, self.mesh,
        ))

    @property
    def n_docs_total(self) -> int:
        if self.index is None:
            return 0
        return max(h.doc_base + h.n_docs for h in self.index.hosts)

    def resident_bytes(self) -> int:
        """Device bytes held by the index's shards."""
        return 0 if self.index is None else self.index.nbytes()

    def add_docs(self, texts) -> list:
        """Incremental add: new docs join the last shard (its global-id
        range stays contiguous); global stats and idf-dependent values
        refresh exactly (the semantics of SearchEngine.add_docs, tested
        bit-identical). Rebalancing across shards is `compact` (or a
        full `build`)."""
        texts = list(texts)
        if not texts:
            return []
        if self.index is None:
            self.build(texts)
            return list(range(len(texts)))
        hosts = self.index.hosts
        last = hosts[-1]
        base0 = self.n_docs_total
        a_new = builder.analyze_texts_fast(texts, self.config)
        merged = builder.AnalyzedDocs(
            hashes=np.concatenate([last.doc_hashes, a_new.hashes]),
            tfs=np.concatenate([last.doc_tfs, a_new.tfs]),
            doc_ptr=np.concatenate(
                [last.doc_ptr, last.doc_ptr[-1] + a_new.doc_ptr[1:]]
            ),
            dl=np.concatenate([last.dl, a_new.dl]),
        )
        new_last = builder.build_host_segment(merged, last.doc_base)
        new_last.alive[: last.n_docs] = last.alive
        # df must count alive docs only: the rebuilt shard counted all
        builder.recompute_alive_df(new_last)
        new_hosts = hosts[:-1] + [new_last]
        if not self._update_last_shard(new_hosts):
            # grew past the padded shapes: full reassembly
            self._set_index(
                assemble_sharded(new_hosts, self.config, self.mesh)
            )
        else:
            self.index.hosts = new_hosts
            self._refresh_sharded_vals()
        return list(range(base0, base0 + a_new.n_docs))

    def _update_last_shard(self, new_hosts) -> bool:
        """O(shard) update for an add that fits the padded shapes: ship
        ONE shard's new planes and lookup tables; every other shard's
        postings stay resident (their idf-dependent values refresh
        separately; their global-row tables refresh only if the global
        vocabulary gained terms). Returns False when the shard or the
        vocabulary outgrew the allocation."""
        idx = self.index
        new_last = new_hosts[-1]
        t_pad = idx.t_pad
        x_rows = idx.x_rows
        row_start, xr = builder.aligned_geometry(
            new_last.indptr, self.config.nnz_pad_to
        )
        new_stats = merge_stats(new_hosts)
        if (
            len(new_stats.vocab) > t_pad
            or xr > x_rows
            or new_last.n_docs + 1 > idx.d_pad
        ):
            return False
        new_last.row_start = row_start
        d2, _v2, t2 = builder._host_planes(
            new_last.post_doc,
            np.zeros(0, np.float32),  # values follow from the refresh
            new_last.post_tf,
            new_last.indptr,
            row_start,
            x_rows,
            new_last.n_docs,
        )
        i = idx.n_shards - 1
        dev = self.mesh.devices[i]
        # new lists: every per-shard list is replaced, never edited, so a
        # list held elsewhere still names the planes it was taken with
        idx.post_doc = idx.post_doc[:i] + [_put(d2, dev)]
        idx.post_tf = idx.post_tf[:i] + [_put(t2, dev)]
        if np.array_equal(new_stats.vocab, idx.stats.vocab):
            # vocabulary unchanged: only the last shard's rows moved
            ip_i, rs_i = _global_tables_one(new_last, new_stats, t_pad)
            idx.indptr_g = idx.indptr_g.copy()
            idx.indptr_g[i] = ip_i
            idx.indptr_d = idx.indptr_d[:i] + [_put(ip_i, dev)]
            idx.row_start_d = idx.row_start_d[:i] + [_put(rs_i, dev)]
        # else: refresh_sharded_vals rebuilds every shard's tables (the
        # global row indices shift; the O(nnz) planes stay resident)
        return True

    def _refresh_sharded_vals(self) -> None:
        refresh_sharded_vals(self.index, self.config, self.mesh)
        self._drop_caches()

    def delete_docs(self, global_ids) -> None:
        """Tombstone docs across shards with exact df, N and avgdl
        updates (delete_from_hosts, as SearchEngine.delete_docs), then
        one value refresh on the shards' devices; postings stay
        resident."""
        if self.index is None:
            return
        if delete_from_hosts(self.index.hosts, global_ids):
            self._refresh_sharded_vals()

    def compact(self) -> None:
        """Physically drop tombstoned docs' postings on every shard.
        Global doc ids stay stable (dead ids keep empty slots and stay
        dead, the SearchEngine.compact contract); results are identical
        before and after (tested). Per shard a host rebuild from the
        alive docs' analyzed terms, then one reassembly."""
        if self.index is None:
            return
        new_hosts = []
        for h in self.index.hosts:
            lens = np.diff(h.doc_ptr).astype(np.int64)
            keep_doc = h.alive
            keep_post = np.repeat(keep_doc, lens)
            ptr = np.zeros(h.n_docs + 1, np.int64)
            np.cumsum(np.where(keep_doc, lens, 0), out=ptr[1:])
            a = builder.AnalyzedDocs(
                hashes=h.doc_hashes[keep_post],
                tfs=h.doc_tfs[keep_post],
                doc_ptr=ptr,
                dl=np.where(keep_doc, h.dl, 0).astype(np.int32),
            )
            nh = builder.build_host_segment(a, h.doc_base)
            nh.alive[:] = h.alive  # dead ids keep empty slots, stay dead
            new_hosts.append(nh)
        self._set_index(assemble_sharded(new_hosts, self.config, self.mesh))

    # ----------------------------------------------------- hybrid rerank
    def _sharded_embeddings(self, dim: int):
        """Per-shard device int8 feature-hash embeddings (d_pad, dim) and
        int32 squared norms, each built on its shard's device from its
        resident posting planes (ops/rerank.py; the projection derives
        from term hashes, so rows are bit-identical to the single
        engine's). Cached until the next mutation."""
        from ..ops.rerank import device_doc_embeddings_int, term_projection

        idx = self.index
        cache = self._emb_cache
        if (
            cache is not None
            and cache[0] == dim
            and all(a is b for a, b in zip(cache[1], idx.post_val))
        ):
            return cache[2]
        d_pad = idx.d_pad
        embs, ssqs = [], []
        for i, h in enumerate(idx.hosts):
            dev = self.mesh.devices[i]
            if h.n_terms == 0 or h.n_docs == 0:
                embs.append(torch.zeros((d_pad, dim), dtype=torch.int8,
                                        device=dev))
                ssqs.append(torch.zeros(d_pad, dtype=torch.int32,
                                        device=dev))
                continue
            col, sign = term_projection(h.term_hash, dim)
            e, ss = device_doc_embeddings_int(
                idx.post_doc[i],
                idx.post_val[i],
                _put(h.row_start.astype(np.int32), dev),
                _put(col, dev),
                _put(sign, dev),
                n_docs=h.n_docs,
                dim=dim,
            )
            pad = d_pad - h.n_docs
            embs.append(torch.cat(
                [e, torch.zeros((pad, dim), dtype=e.dtype, device=dev)]))
            ssqs.append(torch.cat(
                [ss, torch.zeros(pad, dtype=ss.dtype, device=dev)]))
        out = (embs, ssqs)
        self._emb_cache = (dim, tuple(idx.post_val), out)
        return out

    def _rerank_dots(self, qemb, gids, dim: int):
        """ServingEngine.search_rerank's device stage: each shard dots
        the candidates it owns against its resident int8 embeddings and
        an integer psum assembles the exact dots (_sharded_gather_dots)."""
        idx = self.index
        emb, ssq = self._sharded_embeddings(dim)
        return _sharded_gather_dots(
            emb, ssq, idx.doc_base, [h.n_docs for h in idx.hosts],
            _replicate(qemb, self.mesh),
            _replicate(gids.astype(np.int32), self.mesh), mesh_=self.mesh,
        )

    def save(self, path: str) -> None:
        from ..index.checkpoint import save_sharded

        save_sharded(self, path)

    @classmethod
    def load(cls, path: str, mesh: Mesh | None = None):
        """Open a sharded checkpoint saved by either package on `mesh`
        (None: make_mesh(), the card), resharding when its shard count
        differs from the saved one."""
        from ..index.checkpoint import load_sharded

        return load_sharded(path, mesh=mesh)

    def _snapshot(self):
        """ServingEngine's snapshot: the index and its stats (O(delta)
        updates replace the stats in place), None without an index."""
        idx = self.index
        return None if idx is None else (idx, idx.stats)

    def _plan_key(self, s, k, mode):
        """Plan-layout cache key; preplan() and _dispatch must agree."""
        idx = self.index
        return (
            idx.n_shards, idx.d_pad, idx.t_pad, idx.x_rows, s, k, mode,
            self.plan_min_blocks, self.split_rows,
        )

    def _doc_quantiles(self):
        """(offs_h (n_shards, t_pad, P+1) numpy, offs_d per-shard device
        tables, n_loc per-shard local doc counts): the doc-quantile
        tables, built on each shard's device from its resident planes
        and read back ONCE for the host piece planner. Cached by plane
        and table identity, and dropped on every mutation."""
        idx = self.index
        cache = self._quant_cache
        if (
            cache is not None
            and all(a is b for a, b in zip(cache[0], idx.post_doc))
            and all(a is b for a, b in zip(cache[1], idx.indptr_d))
        ):
            return cache[2], cache[3], cache[4]
        p = builder.SPLIT_QUANTILES
        # the device job computes thresholds j*n/P in i32; equal to the
        # host's i64 quantile_doc_bounds below this bound
        assert idx.d_pad * p < 2**31, "doc count overflows i32 quantiles"
        n_loc = [h.n_docs for h in idx.hosts]
        offs_d = _sharded_quantiles(
            idx.post_doc, idx.indptr_d, idx.row_start_d, n_loc, p=p,
        )
        offs_h = np.stack([o.cpu().numpy() for o in offs_d])
        self._quant_cache = (
            tuple(idx.post_doc), tuple(idx.indptr_d), offs_h, offs_d, n_loc,
        )
        return offs_h, offs_d, n_loc

    def _batch_plan(self, analysis, mode, k, families):
        """Shared by preplan and _dispatch: the analyzed batch's slots cut
        to the active pow-2 width, its natural plan and (when splitting)
        the piece table. Returns (rows_p, a_p, cols, qidx, pno, natural);
        cols/qidx/pno are None when the plan rows are the queries
        themselves."""
        _slot_h, coeff, rows, found = active_slots(analysis)
        a_all = np.where(found, coeff, F32(0.0)).astype(F32)
        idx = self.index
        lens_sh = (
            idx.indptr_g[:, rows + 1] - idx.indptr_g[:, rows]
        ) * found[None]
        compact = mode == "fused" and k <= MAX_K
        if not self._split_active(mode, k, families):
            natural = plan_batch_sharded(
                lens_sh, families=families,
                min_blocks=self.plan_min_blocks, compact=compact,
            )
            return rows, a_all, None, None, None, natural
        offs_h, _offs_d, _n_loc = self._doc_quantiles()
        qidx, pno, cols, lens_p_sh = split_pieces_sharded(
            lens_sh, rows, offs_h, self.split_rows, families[0][1],
            builder.SPLIT_QUANTILES,
        )
        natural = plan_batch_sharded(
            lens_p_sh, families=families,
            min_blocks=self.plan_min_blocks, compact=compact,
        )
        return rows[qidx], a_all[qidx], cols, qidx, pno, natural

    def _natural_plans(self, analysis, k, mode, families):
        rows_p, _a, _c, _q, _p, natural = self._batch_plan(
            analysis, mode, k, families
        )
        key = self._plan_key(rows_p.shape[1], k, mode)
        yield key, rows_p.shape[0], natural

    def _dispatch(self, analysis, k: int):
        """Host planning and the device work of one query batch, from
        the frontend's analysis (slot_h, coeff, rows_g, found_g). Rows
        are global, so the host does ONE vocab lookup (inside the
        frontend) and ships one (B_total, S) rows/coefficient-bits pair
        (plus the pieces' quantile columns; fill_buckets) to each
        distinct device of the mesh, from pinned memory on the card;
        per-shard plan tables expand there. Block budgets are
        scorer-tuned families, max-over-shards per bucket. When every
        shard sits on one device the step is the plan's CUDA graph on a
        card (engine/step_graph.py, the reference's one shard_map
        program); a mesh over several cards runs it eagerly (untested:
        one card is in scope). Returns the in-flight device output plus
        assembly metadata: nothing here waits on the card."""
        idx = self.index
        nq = analysis[1].shape[0]
        mode = self._mode_for(k)
        scale, clip = self._scale_clip()
        with dispatch_span(self._graphs, "dispatch.plan"):
            families = self._families(mode)
            split = self._split_active(mode, k, families)
            rows_p, a_p, cols, qidx, pno, natural = self._batch_plan(
                analysis, mode, k, families
            )
            s = rows_p.shape[1]
            slot = None
            if self.plan_cache is not None:
                slot = self._plan_key(s, k, mode)
            blocks = ([], [], [])
            buckets, idxs = fill_buckets(
                self.plan_cache, slot, natural, rows_p, a_p, cols, split,
                blocks,
            )
            inputs = (np.concatenate(blocks[0], axis=0),
                      np.concatenate(blocks[1], axis=0).view(np.int32))
            if split:
                inputs += (np.concatenate(blocks[2]),)
        with dispatch_span(self._graphs, "dispatch.enqueue"):
            plan = (s, tuple(buckets))
            kw = dict(k=k, plan=plan, d_pad=idx.d_pad, scale=scale,
                      clip=clip, mode=mode, mesh_=self.mesh)
            tables = [t for ts in (idx.post_doc, idx.post_val, idx.indptr_d,
                                   idx.row_start_d) for t in ts]
            ints = [*idx.doc_base, idx.d_pad]
            if split:
                _offs_h, offs_d, n_loc = self._doc_quantiles()
                kw.update(quant=offs_d, n_loc=n_loc,
                          split_p=builder.SPLIT_QUANTILES)
                tables += offs_d
                ints += n_loc
            if len(self.mesh.distinct) > 1:
                rep = [_replicate(a, self.mesh) for a in inputs]
                out = _sharded_batch_step(
                    idx.post_doc, idx.post_val, idx.doc_base, idx.indptr_d,
                    idx.row_start_d, rep[0], rep[1],
                    cols_cat=rep[2] if split else None, **kw,
                )
            else:
                step = partial(_step_on_device, self.mesh.dst, idx, kw)
                key = step_key(plan, k, scale, clip, mode, 0,
                               kw.get("split_p", 0), inputs,
                               resident_key(tables, ints))
                self._last_step = (step, inputs)
                out = run_step(self._graphs, slot, key, step, inputs)
        return out, idxs, piece_map(cols, qidx, pno, rows_p.shape[0]), nq, k

    def _collect(self, fut):
        """Force the one device->host read of a dispatched batch and
        assemble (ids, scores); a split query's doc-disjoint pieces
        merge by (score desc, gid asc) on the host (merge_pieces)."""
        out, idxs, pm, nq, k = fut
        n_rows = nq if pm is None else pm[3]
        v = np.full((n_rows, k), -1, np.int64)
        g = np.full((n_rows, k), -1, np.int64)
        host = out.cpu().numpy()  # ONE D2H per batch (vals | gids)
        off = 0
        for idx_q, bq in idxs:
            v[idx_q] = host[off : off + len(idx_q), :k]
            g[idx_q] = host[off : off + len(idx_q), k:]
            off += bq
        if pm is not None:
            v, g = merge_pieces(v, g, pm, nq, k)
        return g[:nq], v[:nq]
