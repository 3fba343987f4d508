"""Index build: host analyze frontend + torch CSR packing on the device.

Port of `document_search_engine_tpu/index/builder.py` (the device build
path). The numpy helpers are the reference's code; the device half
(`device_pack`, `device_align_planes`, `device_materialize_vals`,
`build_segment_device`, `refresh_segment_vals`) is written in torch ops
and produces the reference's planes bit for bit (tests/test_torch_build).

Two reference semantics do not carry over and are made explicit here:
JAX drops out-of-range scatter updates and clamps out-of-range gathers,
while torch raises (CPU) or asserts (CUDA). The bucketed build pads its
triples with sentinel rows `t_cap` and docs `d_pad` that lie past the
scatter targets, so every scatter below masks them out by index.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..analyze import native
from ..analyze.hashing import TermHasher
from ..analyze.tokenizer import Tokenizer
from ..config import IndexConfig
from ..oracle import spec
from .csr import (
    NNZ_SLICE_MARGIN,
    GlobalStats,
    SegmentDevice,
    SegmentHost,
    lookup_sorted,
    round_up,
)

F32 = np.float32
LANES = 128


@dataclass
class AnalyzedDocs:
    """Host batch of analyzed docs: per-doc sorted (hash, tf) runs."""

    hashes: np.ndarray  # (nnz,) uint64, sorted ascending within each doc
    tfs: np.ndarray  # (nnz,) int32
    doc_ptr: np.ndarray  # (n_docs+1,) int64
    dl: np.ndarray  # (n_docs,) int32 — token counts

    @property
    def n_docs(self) -> int:
        return len(self.dl)


def analyze_texts(texts, config: IndexConfig) -> AnalyzedDocs:
    tokenizer = Tokenizer(config.analyzer)
    hasher = TermHasher()
    all_hashes, all_tfs, ptr, dls = [], [], [0], []
    for text in texts:
        toks = tokenizer(text)
        h = hasher.hash_tokens(toks)
        uh, tf = np.unique(h, return_counts=True)  # sorted ascending
        all_hashes.append(uh)
        all_tfs.append(tf.astype(np.int32))
        ptr.append(ptr[-1] + len(uh))
        dls.append(len(toks))
    return AnalyzedDocs(
        hashes=(
            np.concatenate(all_hashes)
            if all_hashes
            else np.zeros(0, np.uint64)
        ),
        tfs=np.concatenate(all_tfs) if all_tfs else np.zeros(0, np.int32),
        doc_ptr=np.array(ptr, dtype=np.int64),
        dl=np.array(dls, dtype=np.int32),
    )


def analyze_texts_fast(texts, config: IndexConfig) -> AnalyzedDocs:
    """analyze_texts with the native C analyzer on the ASCII docs; the
    non-ASCII ones take the Python tokenizer. Output equals
    analyze_texts exactly (the reference's contract, tested there)."""
    texts = list(texts)
    if not native.available() or not native.config_supported(config.analyzer):
        return analyze_texts(texts, config)
    n = len(texts)
    ascii_all = ("".join(texts)).isascii() if texts else True
    if ascii_all:
        hashes, tfs, doc_ptr, dl = native.analyze_batch_ascii(
            texts, config.analyzer
        )
        return AnalyzedDocs(
            hashes=hashes, tfs=tfs, doc_ptr=doc_ptr, dl=dl.astype(np.int32)
        )
    # mixed: native for the ASCII docs, Python reference for the rest,
    # reassembled in original doc order
    ascii_ids = [i for i, t in enumerate(texts) if t.isascii()]
    h_a, tf_a, ptr_a, dl_a = native.analyze_batch_ascii(
        [texts[i] for i in ascii_ids], config.analyzer
    )
    pos_of = {g: i for i, g in enumerate(ascii_ids)}
    tokenizer = Tokenizer(config.analyzer)
    hasher = TermHasher()
    parts_h, parts_tf, ptr, dls = [], [], [0], []
    for g in range(n):
        if g in pos_of:
            i = pos_of[g]
            s, e = ptr_a[i], ptr_a[i + 1]
            parts_h.append(h_a[s:e])
            parts_tf.append(tf_a[s:e])
            ptr.append(ptr[-1] + (e - s))
            dls.append(int(dl_a[i]))
        else:
            toks = tokenizer(texts[g])
            hh = hasher.hash_tokens(toks)
            uh, tf = np.unique(hh, return_counts=True)
            parts_h.append(uh)
            parts_tf.append(tf.astype(np.int32))
            ptr.append(ptr[-1] + len(uh))
            dls.append(len(toks))
    return AnalyzedDocs(
        hashes=(
            np.concatenate(parts_h) if parts_h else np.zeros(0, np.uint64)
        ),
        tfs=(
            np.concatenate(parts_tf) if parts_tf else np.zeros(0, np.int32)
        ),
        doc_ptr=np.array(ptr, dtype=np.int64),
        dl=np.array(dls, dtype=np.int32),
    )


def segment_vocab(analyzed: AnalyzedDocs):
    """(vocab uint64 sorted, rows int32 per posting, df int32 per term),
    through the native hash-table unique on large inputs (identical
    output to np.unique)."""
    if len(analyzed.hashes) >= 65536 and native.hash_lookup_available():
        vocab, rows, df = native.unique_inverse(
            analyzed.hashes, counts=True
        )
    else:
        vocab, rows64 = np.unique(analyzed.hashes, return_inverse=True)
        rows = rows64.astype(np.int32)
        df = np.bincount(rows, minlength=len(vocab)).astype(np.int32)
    return vocab, rows, df


def device_pack(
    rows: torch.Tensor,  # (nnz,) int32 term rows; sentinel n_terms
    docs: torch.Tensor,  # (nnz,) int32 doc ids; sentinel n_docs
    tfs: torch.Tensor,  # (nnz,) int32
    n_terms: int,
    n_docs: int,
):
    """CSR pack on the device: ONE sort on the int64 key (row << 32) |
    doc (rows and docs are non-negative, so the key order is the
    (row, doc) order), then searchsorted indptr and the df/dl counts.
    Returns (r, d, t, indptr, df, dl) like the reference. Sentinel
    triples (row == n_terms, doc == n_docs) sort last and are masked
    out of the df/dl scatters, where JAX dropped them as out of range."""
    key = (rows.to(torch.int64) << 32) | docs.to(torch.int64)
    key_s, order = torch.sort(key, stable=True)
    r64 = key_s >> 32
    r = r64.to(torch.int32)
    d = (key_s & 0xFFFFFFFF).to(torch.int32)
    t = tfs[order]
    dev = rows.device
    indptr = torch.searchsorted(
        r64, torch.arange(n_terms + 1, dtype=torch.int64, device=dev)
    ).to(torch.int32)
    live_r = r < n_terms
    df = torch.bincount(r[live_r].long(), minlength=n_terms)[:n_terms]
    live_d = d < n_docs
    dl = torch.zeros(n_docs, dtype=torch.int32, device=dev).index_add_(
        0, d[live_d].long(), t[live_d]
    )
    return r, d, t, indptr, df.to(torch.int32), dl


def exact_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 division, the reference's residual
    correction step (a Veltkamp split / Dekker two-product makes the
    residual r = a - b*q0 exact, and q0 + r/b rounds to the true
    quotient). torch's f32 division is already IEEE-exact on the CPU
    and on CUDA, where this is a no-op (q0 right => r ~ 0); it is kept
    so that the arithmetic is the reference's op for op. Each line is a
    separate torch op, so no mul+add pair can be contracted into an FMA."""
    q0 = a / b
    c = 4097.0  # Veltkamp split point (2^12 + 1), exact in f32

    def split(x):
        t = x * c
        hi = t - (t - x)
        return hi, x - hi

    bh, bl = split(b)
    qh, ql = split(q0)
    p = b * q0
    e = ((bh * qh - p) + bh * ql + bl * qh) + bl * ql
    r = (a - p) - e
    return q0 + r / b


def device_materialize_vals(
    post_doc: torch.Tensor,  # (X, 128) i32 — sentinel n_docs in padding
    post_tf: torch.Tensor,  # (X, 128) i32 — 0 in padding
    k_doc: torch.Tensor,  # (d_pad,) f32 — bm25 K(dl), computed on HOST
    inv_norm: torch.Tensor,  # (d_pad,) f32 (tfidf; ignored for bm25)
    alive: torch.Tensor,  # (d_pad,) bool
    k1p1: torch.Tensor,  # f32 0-d tensor — bm25 numerator factor k1 + 1
    kind: str,
) -> torch.Tensor:
    """The bitcast-f32 posting value plane from device-resident inputs.

    K(dl) = c0 + c1*dl stays on the host (numpy, exactly rounded mul
    then add), as in the reference: a fused multiply-add on the device
    would drift 1 ulp off oracle/spec.py's val_bm25. The device ops here
    (gather, add, mul, div) hold no mul->add pair. Padding postings
    (tf 0, K 0) divide 0/0 = NaN in bm25, so the alive mask is an
    explicit select, never a multiply: the padding bits are +0.0."""
    tff = post_tf.to(torch.float32)
    pd = post_doc.long()
    if kind == "tfidf":
        val = tff * inv_norm[pd]
    else:  # bm25: val = (tf*(k1+1)) / (tf + K[doc]), exactly rounded
        val = exact_div(tff * k1p1, tff + k_doc[pd])
    val = torch.where(alive[pd], val, torch.zeros_like(val))
    return val.view(torch.int32)


def device_align_planes(
    r: torch.Tensor,  # (nnz,) sorted term rows, sentinel rows past T
    d: torch.Tensor,  # (nnz,) doc ids (sorted within rows)
    t: torch.Tensor,  # (nnz,) tfs
    indptr: torch.Tensor,  # (T+1,) true cumulative lengths
    row_start: torch.Tensor,  # (T,) aligned flat starts
    x_rows: int,
    n_docs: int,
):
    """Scatter the sorted postings into the aligned (X, 128) doc/tf
    planes. Sentinel postings (row >= T) and any position outside the
    plane are masked by index before the scatter (the reference relied
    on XLA dropping them)."""
    nnz = d.shape[0]
    n_rows = row_start.shape[0]
    dev = d.device
    live = r < n_rows
    rl = r[live].long()
    i = torch.arange(nnz, dtype=torch.int64, device=dev)[live]
    pos = row_start[rl].long() + (i - indptr[rl].long())
    inside = (pos >= 0) & (pos < x_rows * LANES)
    pos = pos[inside]
    doc2 = torch.full((x_rows * LANES,), n_docs, dtype=torch.int32, device=dev)
    tf2 = torch.zeros(x_rows * LANES, dtype=torch.int32, device=dev)
    doc2[pos] = d[live][inside]
    tf2[pos] = t[live][inside]
    return doc2.reshape(x_rows, LANES), tf2.reshape(x_rows, LANES)


# Doc-range split quantiles (ops/schedule.py split_pieces): each term
# row's postings are doc-ascending, so a (T, P+1) table of "count of
# postings with doc < j*n_docs/P" lets the planner cut any row into P
# doc-disjoint ranges with exact lengths. P=8 bounds the table at T x 9
# int32 and gives heavy queries up to 8-way splits.
SPLIT_QUANTILES = 8


def quantile_doc_bounds(p: int, n_docs: int) -> np.ndarray:
    """(p+1,) int64 doc thresholds D_j = floor(j * n_docs / p); piece j
    covers docs [D_j, D_{j+1})."""
    return (np.arange(p + 1, dtype=np.int64) * n_docs) // p


def host_row_doc_quantiles(
    indptr: np.ndarray,  # (T+1,) true cumulative lengths
    post_doc: np.ndarray,  # (nnz,) packed postings, doc-ascending per row
    p: int,
    n_docs: int,
) -> np.ndarray:
    """(T, p+1) int32: offs[t, j] = count of row t's postings with
    doc < D_j (quantile_doc_bounds); offs[:, 0] = 0, offs[:, p] = row
    length. Vectorized: one cumsum of (doc < D) per interior threshold.
    The engine keeps no host postings and uses the device form; this one
    is the tests' yardstick."""
    t_n = len(indptr) - 1
    offs = np.zeros((t_n, p + 1), np.int32)
    if t_n == 0:
        return offs
    bounds = quantile_doc_bounds(p, n_docs)
    lens = (indptr[1:] - indptr[:-1]).astype(np.int64)
    for j in range(1, p):
        cum = np.zeros(len(post_doc) + 1, np.int64)
        np.cumsum(post_doc < bounds[j], out=cum[1:])
        offs[:, j] = (cum[indptr[1:]] - cum[indptr[:-1]]).astype(np.int32)
    offs[:, p] = lens.astype(np.int32)
    return offs


def device_row_doc_quantiles(
    post_doc2: torch.Tensor,  # (X, 128) i32 aligned doc plane
    indptr: torch.Tensor,  # (T+1,) i32 true cumulative lengths
    row_start: torch.Tensor,  # (T,) i32 aligned flat record starts
    p: int,
    n_docs: int,
) -> torch.Tensor:
    """host_row_doc_quantiles over the ALIGNED device plane: per (row,
    interior threshold) a branch-free int32 binary search of 32 steps on
    the row's doc-ascending records, all (T, p-1) searches at once.
    Sentinel padding (doc = n_docs) sorts past every threshold. A probe
    past a row's end reads the next row's records (a row whose length is
    a multiple of 128, or a zero-length row), so the result is clamped
    to the row length, as the reference does. Probes outside the plane
    clamp to its last record, as XLA's gather does."""
    dev = post_doc2.device
    flat = post_doc2.reshape(-1)
    lens = indptr[1:] - indptr[:-1]
    t_n = int(row_start.shape[0])
    bounds = torch.from_numpy(
        quantile_doc_bounds(p, n_docs)[1:p].astype(np.int32)
    ).to(dev)
    lo = torch.zeros((t_n, p - 1), dtype=torch.int32, device=dev)
    hi = lens[:, None].expand(t_n, p - 1).contiguous()
    start = row_start[:, None].long()
    last = max(int(flat.numel()) - 1, 0)
    for _ in range(32):
        mid = (lo + hi) // 2
        v = flat[(start + mid.long()).clamp(max=last)]
        right = v < bounds
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    mids = torch.minimum(lo, lens[:, None])
    return torch.cat(
        [
            torch.zeros((t_n, 1), dtype=torch.int32, device=dev),
            mids.to(torch.int32),
            lens.reshape(t_n, 1).to(torch.int32),
        ],
        dim=1,
    )


def aligned_geometry(indptr: np.ndarray, pad_to: int):
    """(row_start (T,) i64, X): 128-aligned flat start offset per term
    row in the (X, 128) posting planes, and the plane row count (with
    the NNZ_SLICE_MARGIN tail, rounded to pad_to records)."""
    lens = np.diff(indptr).astype(np.int64)
    al_lens = -(-lens // LANES) * LANES
    row_start = np.zeros(len(lens), np.int64)
    np.cumsum(al_lens[:-1], out=row_start[1:])
    total = int(al_lens.sum())
    records = max(
        round_up(total + NNZ_SLICE_MARGIN, max(pad_to, LANES)), LANES
    )
    return row_start, records // LANES


def host_k_doc(dl: np.ndarray, config: IndexConfig, stats: GlobalStats):
    """(n_docs,) f32 bm25 K(dl) = c0 + c1*dl in spec op order."""
    # no alive docs, or only empty ones (avgdl 0): K is never used
    if stats.n_alive == 0 or stats.total_len_alive == 0:
        return np.zeros(len(dl), F32)
    avgdl = spec.avgdl_of(stats.total_len_alive, stats.n_alive)
    c0, c1 = spec.bm25_len_coeffs(
        config.scoring.k1, config.scoring.b, avgdl
    )
    return (c0 + c1 * dl.astype(F32)).astype(F32)


def recompute_alive_df(host: SegmentHost) -> None:
    """Recount host.df over alive docs only, from the per-doc analyzed
    terms (the ground truth of the delete path's df decrements)."""
    doc_of = np.repeat(
        np.arange(host.n_docs, dtype=np.int64),
        np.diff(host.doc_ptr).astype(np.int64),
    )
    mask = host.alive[doc_of]
    rows = lookup_sorted(host.term_hash, host.doc_hashes[mask])
    host.df = np.bincount(
        rows, minlength=host.n_terms
    ).astype(np.int32)


def _stats_key(stats: GlobalStats):
    """Cheap fingerprint of the inv-norm inputs (n_alive, vocab, df)."""
    import zlib

    return (
        stats.n_alive,
        len(stats.vocab),
        zlib.crc32(np.ascontiguousarray(stats.df).tobytes()),
        zlib.crc32(np.ascontiguousarray(stats.vocab).tobytes()),
    )


def refresh_inputs(
    host: SegmentHost, config: IndexConfig, stats: GlobalStats
):
    """The small per-doc host arrays a device val refresh needs:
    (k_doc, inv_norm, alive), each (n_docs,). tfidf inv-norms are
    memoized per segment on the global-stats fingerprint."""
    kind = config.scoring.kind
    if kind == "tfidf":
        key = _stats_key(stats)
        cached = getattr(host, "_inv_norm_cache", None)
        if cached is not None and cached[0] == key:
            inv_norm = cached[1]
        else:
            analyzed = AnalyzedDocs(
                hashes=host.doc_hashes,
                tfs=host.doc_tfs,
                doc_ptr=host.doc_ptr,
                dl=host.dl,
            )
            inv_norm = doc_inv_norms(analyzed, stats, kind)
            host._inv_norm_cache = (key, inv_norm)
    else:
        inv_norm = np.zeros(host.n_docs, dtype=F32)
    return host_k_doc(host.dl, config, stats), inv_norm, host.alive


def doc_inv_norms(
    analyzed: AnalyzedDocs, stats: GlobalStats, kind: str, chunk: int = 4096
) -> np.ndarray:
    """Per-doc inverse norms for tfidf (spec order: hash-ascending
    sequential f32 sum of squares over a padded (chunk, Lmax) matrix;
    trailing zero padding is exact)."""
    n = analyzed.n_docs
    out = np.zeros(n, dtype=F32)
    idf_g = spec.idf_of(kind, stats.n_alive, stats.df)
    rows_g = stats.lookup(analyzed.hashes)
    w_all = spec.doc_weights_tfidf(analyzed.tfs, idf_g[rows_g])
    ptr = analyzed.doc_ptr
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        lens = (ptr[c0 + 1 : c1 + 1] - ptr[c0:c1]).astype(np.int64)
        lmax = int(lens.max()) if len(lens) else 0
        mat = np.zeros((c1 - c0, max(lmax, 1)), dtype=F32)
        starts = (ptr[c0:c1] - ptr[c0]).astype(np.int64)
        ridx = np.repeat(np.arange(c1 - c0, dtype=np.int64), lens)
        cidx = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
            starts, lens
        )
        mat[ridx, cidx] = w_all[ptr[c0] : ptr[c1]]
        sumsq = spec.seq_sumsq(mat, axis=1)
        out[c0:c1] = spec.inv_norm_from_sumsq(sumsq)
    return out


def _pad(a, size, fill, dtype):
    out = np.full(size, fill, dtype=dtype)
    out[: len(a)] = a
    return out


def shape_bucket(n: int, granule: int = 256) -> int:
    """Round n up to the next multiple of max(granule, 2^(floor(log2 n)
    - 4)): <= ~6.25% padding. Kept from the reference so the port's
    planes have the reference's shapes (and bits) exactly."""
    n = max(int(n), 1)
    step = max(granule, 1 << max(int(np.log2(n)) - 4, 0))
    return ((n + step - 1) // step) * step


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def refresh_segment_vals(
    host: SegmentHost,
    device: SegmentDevice,
    config: IndexConfig,
    stats: GlobalStats,
) -> SegmentDevice:
    """Re-materialize the df/N/avgdl-dependent values on the device from
    the resident doc/tf planes; only the small per-doc alive/inv_norm/
    K(dl) arrays move host -> device."""
    d_pad = device.n_docs_pad
    dev = device.post_doc.device
    k_host, inv_norm, alive = refresh_inputs(host, config, stats)
    inv_d = _to_device(_pad(inv_norm, d_pad, 0, np.float32), dev)
    alive_d = _to_device(_pad(alive, d_pad, False, bool), dev)
    k_doc = _to_device(_pad(k_host, d_pad, 0, np.float32), dev)
    post_val = device_materialize_vals(
        device.post_doc,
        device.post_tf,
        k_doc,
        inv_d,
        alive_d,
        torch.tensor(F32(config.scoring.k1 + 1.0), device=dev),
        kind=config.scoring.kind,
    )
    return SegmentDevice(
        indptr=device.indptr,
        row_start=device.row_start,
        post_doc=device.post_doc,
        post_val=post_val,
        post_tf=device.post_tf,
        dl=device.dl,
        alive=alive_d,
        inv_norm=inv_d,
    )


def build_segment_device(
    analyzed: AnalyzedDocs,
    config: IndexConfig,
    device,
    doc_base: int = 0,
) -> tuple:
    """Device-side segment build: the analyzed (row, doc, tf) triples
    ship to the device once; the CSR pack, the aligned scatter and the
    value materialization run there. The host keeps the vocabulary,
    stats, per-doc analyzed terms and the true-prefix indptr/row_start
    for planning; the O(nnz) postings never come back.

    Shapes are bucketed exactly as in the reference (shape_bucket), so
    the planes, indptr and row_start are the reference's bit for bit,
    padding included: sentinel rows t_cap sort last and fall outside
    indptr's true prefix, and padded row_start entries point one past
    the plane."""
    n_docs = analyzed.n_docs
    vocab, rows, df = segment_vocab(analyzed)
    docs = np.repeat(
        np.arange(n_docs, dtype=np.int32),
        np.diff(analyzed.doc_ptr).astype(np.int64),
    )
    d_pad = round_up(n_docs + 1, config.docs_pad_to)
    nnz = len(rows)
    t_cap = shape_bucket(len(vocab) + 1)  # strictly > true vocab
    nnz_cap = shape_bucket(max(nnz, 1))
    rows_p = _pad(rows, nnz_cap, t_cap, np.int32)
    docs_p = _pad(docs, nnz_cap, d_pad, np.int32)
    tfs_p = _pad(analyzed.tfs, nnz_cap, 0, np.int32)
    r_d, d_d, t_d, indptr_d, _df_d, _dl_d = device_pack(
        _to_device(rows_p, device),
        _to_device(docs_p, device),
        _to_device(tfs_p, device),
        n_terms=t_cap,
        n_docs=d_pad,
    )
    # small D2H: planning needs the true-prefix indptr
    indptr = indptr_d[: len(vocab) + 1].cpu().numpy()
    row_start, x_rows = aligned_geometry(indptr, config.nnz_pad_to)
    x_cap = shape_bucket(max(x_rows, 1))
    row_start_d = _to_device(
        _pad(row_start, t_cap, x_cap * LANES, np.int64).astype(np.int32),
        device,
    )
    doc2, tf2 = device_align_planes(
        r_d, d_d, t_d, indptr_d, row_start_d, x_rows=x_cap, n_docs=n_docs,
    )
    del r_d, d_d, t_d
    host = SegmentHost(
        term_hash=vocab,
        df=df,
        doc_base=doc_base,
        n_docs=n_docs,
        dl=analyzed.dl.copy(),
        alive=np.ones(n_docs, dtype=bool),
        doc_hashes=analyzed.hashes,
        doc_tfs=analyzed.tfs,
        doc_ptr=analyzed.doc_ptr,
        indptr=indptr,
        row_start=row_start,
    )
    stats = GlobalStats(
        vocab=vocab,
        df=df.copy(),
        n_alive=n_docs,
        total_len_alive=int(analyzed.dl.sum()),
    )
    kind = config.scoring.kind
    if kind == "tfidf":
        inv_norm = doc_inv_norms(analyzed, stats, kind)
    else:
        inv_norm = np.zeros(n_docs, dtype=F32)
    inv_d = _to_device(_pad(inv_norm, d_pad, 0, np.float32), device)
    alive_d = _to_device(_pad(host.alive, d_pad, False, bool), device)
    dl_dev = _to_device(_pad(host.dl.astype(F32), d_pad, 0, np.float32), device)
    k_doc = _to_device(
        _pad(host_k_doc(host.dl, config, stats), d_pad, 0, np.float32),
        device,
    )
    val2 = device_materialize_vals(
        doc2,
        tf2,
        k_doc,
        inv_d,
        alive_d,
        torch.tensor(F32(config.scoring.k1 + 1.0), device=device),
        kind=kind,
    )
    seg = SegmentDevice(
        indptr=indptr_d,
        row_start=row_start_d,
        post_doc=doc2,
        post_val=val2,
        post_tf=tf2,
        dl=dl_dev,
        alive=alive_d,
        inv_norm=inv_d,
    )
    return host, seg
