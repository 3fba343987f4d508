"""The torch port stands alone: it imports, builds, serves and reranks in
a process where importing jax or the JAX package fails (the sharded
engine on a 2-shard CPU mesh too); no module of the port (the compiled
batch step, engine/step_graph.py, among them), and not chip_smoke.py,
imports either; the engine runs on the card
unless asked for the CPU, and asking for the card without CUDA raises;
its xla_rank, fused_dv and split paths, its lifecycle (add, delete,
compact), its checkpoints, its CLI, its entry points (entry.py), its
phase timers, its benchmark's synthetic index (bench.py) and its tools
(tools/: the differential fuzz, the segments curve, the lever A/B and
the roofline's host account) run on the CPU;
the kernel
wrapper takes its plain version for CPU tensors without counting a
launch; and each host module the port keeps its own copy of behaves as
its original in the JAX package on the same inputs."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "document_search_engine_tpu_torch"
BLOCKED = ("jax", "jaxlib", "document_search_engine_tpu")

_BLOCKED_RUN = r"""
import sys

BLOCKED = ("jax", "jaxlib", "document_search_engine_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this process")
        return None

sys.meta_path.insert(0, Block())
from document_search_engine_tpu_torch import IndexConfig, SearchEngine
from document_search_engine_tpu_torch.oracle import OracleEngine

docs = ["the quick brown fox", "a lazy dog sleeps", "quick dogs and foxes",
        "brown dog"]
eng = SearchEngine(IndexConfig(), device="cpu")
eng.build(docs)
ids, scores = eng.search(["quick fox", "dog", "nothing"], k=3)
ora = OracleEngine(IndexConfig())
ora.build(docs)
o_ids, o_scores = ora.search(["quick fox", "dog", "nothing"], k=3)
assert (ids == o_ids).all() and (scores == o_scores).all(), (ids, o_ids)
assert ids[0, 0] >= 0 and ids[2, 0] == -1
# the sharded engine on a 2-shard CPU mesh, and its sharded rerank
from document_search_engine_tpu_torch import DistributedSearchEngine, make_mesh
dist = DistributedSearchEngine(IndexConfig(), mesh=make_mesh(2, device="cpu"))
dist.build(docs)
d_ids, d_scores = dist.search(["quick fox", "dog", "nothing"], k=3)
assert (d_ids == o_ids).all() and (d_scores == o_scores).all(), d_ids
d_rr = dist.search_rerank(["quick fox", "dog"], k=2, candidates=4)
for g, w in zip(d_rr, eng.search_rerank(["quick fox", "dog"], k=2,
                                        candidates=4)):
    assert (g == w).all(), (g, w)
r_ids, r_sc, r_lex = eng.search_rerank(["quick fox", "dog"], k=2,
                                       candidates=4)
assert r_ids.shape == (2, 2) and set(r_ids[1]) <= {1, 2, 3}, r_ids
# the xla_rank, fused_dv and split paths (ops/rank.py, ops/fused_dv.py)
import document_search_engine_tpu_torch.engine.step_graph
import document_search_engine_tpu_torch.ops.fused_dv
import document_search_engine_tpu_torch.ops.rank
for scorer, split in (("xla_rank", None), ("fused_dv", None), ("fused", 1)):
    eng.scorer, eng.split_rows = scorer, split
    p_ids, p_scores = eng.search(["quick fox", "dog", "nothing"], k=3)
    assert (p_ids == o_ids).all() and (p_scores == o_scores).all(), scorer
eng.scorer, eng.split_rows = None, None
# the lifecycle, a checkpoint and the CLI
import contextlib, io, tempfile
from document_search_engine_tpu_torch.cli import main
eng.add_docs(["a quick lazy fox"])
eng.delete_docs([0, 2])
ora.add_docs(["a quick lazy fox"])
ora.delete_docs([0, 2])
eng.compact()
assert len(eng.segments) == 1
want = ora.search(["quick fox", "dog", "nothing"], k=3)
got = eng.search(["quick fox", "dog", "nothing"], k=3)
assert (got[0] == want[0]).all() and (got[1] == want[1]).all(), got
with tempfile.TemporaryDirectory() as d:
    eng.save(d)
    got = SearchEngine.load(d, device="cpu").search(["quick fox"], k=3)
    assert (got[0] == want[0][:1]).all(), got
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["search", d, "quick fox", "--device", "cpu"]) == 0
    assert f"(doc {want[0][0, 0]})" in out.getvalue(), out.getvalue()
# the entry points and the phase timers
import json
from document_search_engine_tpu_torch.entry import dryrun_multichip, entry
from document_search_engine_tpu_torch.utils import prof
fn, args = entry(device="cpu")
vals, gids = fn(*args)
assert tuple(vals.shape) == (8, 10) and (vals[:, 0] > 0).all(), vals
dryrun_multichip(2, device="cpu")
prof.reset()
eng.search(["quick fox"], k=3)
assert set(json.loads(prof.metrics_json())["phases_s"]) == {
    "search.analyze", "search.score"}
# the benchmark's synthetic index
from document_search_engine_tpu_torch import bench
b_eng, b_df, b_tok = bench.build_synth_engine(600, 400, 10, IndexConfig(),
                                              device="cpu")
b_batches, _avg = bench.make_batches(b_df, b_tok, 8, 4, 1)
b_ids, _b_sc = b_eng.search(b_batches[0], k=5)
assert b_ids.shape == (8, 5) and (b_ids[:, 0] >= 0).all(), b_ids
# the ported tools: one fuzz trial on 2 shards and a tiny segments curve
import document_search_engine_tpu_torch.tools.host_profile
import document_search_engine_tpu_torch.tools.nq_ab
from document_search_engine_tpu_torch.tools import (
    fuzz_differential, segments_bench)
assert fuzz_differential.trial_config(34)["n_shards"] == 2
fuzz_differential.one_trial(34, device="cpu")
seg = segments_bench.main(device="cpu", env={
    "SEG_DOCS": "200", "SEG_VOCAB": "150", "SEG_NQ": "16", "SEG_ITERS": "1",
    "SEG_COUNTS": "1,2"})
assert set(seg["curve"]) == {1, 2} and (seg["ids"][:, 0] >= 0).any(), seg
# the lever A/B at a tiny size, and the roofline's host account
from document_search_engine_tpu_torch.tools import roofline, step_ab
ab = step_ab.main(device="cpu", env={
    "AB_DOCS": "600", "AB_VOCAB": "400", "AB_NQ": "8", "AB_ITERS": "1",
    "STEP_AB": "block2048,threads16"})
assert [r["name"] for r in ab["results"]] == [
    "baseline", "block2048", "threads16"], ab
rf = roofline.main(device="cpu", env={
    "BENCH_DOCS": "3000", "BENCH_VOCAB": "2000", "BENCH_NQ": "16",
    "ROOF_CARD": "0"})
assert rf["card"] is None and rf["host"], rf
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("OK")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_no_module_of_the_port_imports_jax():
    paths = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert not (PKG / "shared.py").exists()
    # the compiled batch step and the ported tools are walked like every
    # module; none imports the repo-root tools/ or bench.py either
    assert PKG / "engine" / "step_graph.py" in paths
    assert PKG / "tools" / "fuzz_differential.py" in paths
    for name in ("nq_ab", "step_ab", "roofline"):
        assert PKG / "tools" / f"{name}.py" in paths
    for path in paths:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BLOCKED + (
                    "tools", "bench"), (
                    f"{path.relative_to(REPO)}:{node.lineno} imports {name}"
                )


def test_cuda_engine_without_cuda_raises(monkeypatch):
    from document_search_engine_tpu_torch import SearchEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SearchEngine(device="cuda")


def test_engine_defaults_to_the_card(monkeypatch):
    """SearchEngine() means the card: without CUDA it raises, and with
    CUDA reported it is placed there; the CPU is asked for by name."""
    from document_search_engine_tpu_torch import SearchEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SearchEngine()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert SearchEngine().device.type == "cuda"
    # the plain scorer is the reference's "xla" mode; "plain" names it too
    eng = SearchEngine(device="cpu")
    assert eng.scorer_mode == "xla"
    eng.scorer = "plain"
    assert eng.scorer_mode == "xla"


def test_further_paths_serve_on_cpu_and_card_still_required(monkeypatch):
    """The xla_rank and fused_dv scorers and doc-range splitting no
    longer raise NotImplementedError: on the CPU they serve the oracle's
    results; a SearchEngine() without CUDA still raises."""
    from document_search_engine_tpu_torch import SearchEngine
    from document_search_engine_tpu_torch.oracle import OracleEngine

    docs = ["alpha beta gamma", "beta gamma", "gamma delta alpha", "delta"]
    queries = ["alpha gamma", "beta", "delta alpha", "none"]
    ora = OracleEngine()
    ora.build(docs)
    want = ora.search(queries, k=3)
    for scorer, split in (("xla_rank", None), ("fused_dv", None),
                          ("fused", 1), ("fused", 64)):
        eng = SearchEngine(device="cpu")
        eng.scorer, eng.split_rows = scorer, split
        eng.build(docs)
        eng.preplan([queries], k=3)
        got = eng.search(queries, k=3)
        np.testing.assert_array_equal(got[0], want[0], f"{scorer} {split}")
        np.testing.assert_array_equal(got[1], want[1], f"{scorer} {split}")
    eng.scorer = "no_such_scorer"
    with pytest.raises(ValueError, match="unknown scorer"):
        eng.search(queries)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SearchEngine()


def test_wrapper_takes_plain_version_on_cpu_tensors():
    from document_search_engine_tpu_torch.ops import fused
    from document_search_engine_tpu_torch.ops.packed import (
        search_packed_tables,
    )

    rng = np.random.default_rng(0)
    x_rows, n_docs = 64, 500
    d2 = np.sort(rng.integers(0, n_docs, (x_rows, 128)), axis=1)
    d2 = torch.from_numpy(d2.astype(np.int32))
    v2 = torch.from_numpy(
        rng.random((x_rows, 128), dtype=np.float32) + 0.1
    ).view(torch.int32)
    indptr = torch.tensor([0, 128, 300, 700], dtype=torch.int32)
    row_start = torch.tensor([0, 128, 384], dtype=torch.int32)
    rows = torch.tensor([[0, 2], [1, 2], [2, 0]], dtype=torch.int32)
    cb = torch.tensor([[1.0, 0.5], [0.0, 2.0], [1.5, 0.0]]).view(torch.int32)
    tabs = fused.expand_plan_tables(row_start, indptr, rows, cb, 8, 256)
    for k in (5, 40):
        launches = (fused.fused_search.launches,
                    fused.fused_search.launches_large_k)
        got = fused.fused_search(
            d2, v2, *tabs, n_blocks=8, block=256, s=2, k=k, n_docs=n_docs,
            scale=65536.0, clip=65075262.0, r_c=16, key_bits=1,
        )
        want = search_packed_tables(
            d2, v2, *tabs[:3], 65536.0, 65075262.0, 0, n_blocks=8,
            block=256, s=2, k=k, n_docs=n_docs,
        )
        assert (fused.fused_search.launches,
                fused.fused_search.launches_large_k) == launches
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
        assert (got[0] > 0).any()


# ------------------------------------------- copies against originals
def _texts():
    from document_search_engine_tpu_torch.corpus import synth as port_synth
    from document_search_engine_tpu.corpus import synth as ref_synth

    docs = port_synth.synth_corpus(n_docs=60, vocab_size=300, mean_len=20,
                                   seed=3)
    assert docs == ref_synth.synth_corpus(n_docs=60, vocab_size=300,
                                          mean_len=20, seed=3)
    queries = port_synth.synth_queries(docs, n_queries=12, seed=4)
    assert queries == ref_synth.synth_queries(docs, n_queries=12, seed=4)
    extra = ["", "Hello, WORLD!! 42 x_y-z", "naïve café über straße",
             "a" * 70 + " short"]
    return docs + queries + extra


def _check_tokenizer_and_hasher():
    from document_search_engine_tpu.analyze import hashing as ref_h
    from document_search_engine_tpu.analyze import tokenizer as ref_t
    from document_search_engine_tpu.config import AnalyzerConfig as RefA
    from document_search_engine_tpu_torch.analyze import hashing as port_h
    from document_search_engine_tpu_torch.analyze import tokenizer as port_t
    from document_search_engine_tpu_torch.config import AnalyzerConfig

    for kw in ({}, {"stopwords": ("the", "a"), "min_token_len": 2}):
        port_tok = port_t.Tokenizer(AnalyzerConfig(**kw))
        ref_tok = ref_t.Tokenizer(RefA(**kw))
        for text in _texts():
            toks = port_tok(text)
            assert toks == ref_tok(text), text
            np.testing.assert_array_equal(
                port_h.TermHasher().hash_tokens(toks),
                ref_h.TermHasher().hash_tokens(toks),
            )
            assert [port_h.fnv1a64(t) for t in toks] == [
                ref_h.fnv1a64(t) for t in toks
            ]


def _check_native_analyzer():
    from document_search_engine_tpu.analyze import native as ref_n
    from document_search_engine_tpu.config import AnalyzerConfig as RefA
    from document_search_engine_tpu_torch.analyze import native as port_n
    from document_search_engine_tpu_torch.config import AnalyzerConfig

    # both load native/libdse_native.so, built from native/analyzer.cpp
    assert port_n.available() and ref_n.available()
    texts = [t for t in _texts() if t.isascii()]
    for got, want in (
        (port_n.analyze_batch_ascii(texts, AnalyzerConfig()),
         ref_n.analyze_batch_ascii(texts, RefA())),
        (port_n.hash_batch_ascii(texts, AnalyzerConfig()),
         ref_n.hash_batch_ascii(texts, RefA())),
    ):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    vocab = np.unique(port_n.hash_batch_ascii(texts, AnalyzerConfig())[0])
    np.testing.assert_array_equal(port_n.unique_inverse(vocab)[0],
                                  ref_n.unique_inverse(vocab)[0])


def _check_plan_cache():
    from document_search_engine_tpu.ops.plan_cache import (
        PlanLayoutCache as RefCache,
    )
    from document_search_engine_tpu_torch.ops.plan_cache import (
        PlanLayoutCache,
    )
    from document_search_engine_tpu_torch.ops.schedule import (
        FUSED_FAMILIES,
        plan_batch,
    )

    rng = np.random.default_rng(9)
    n_terms = 60
    lens = rng.integers(0, 30_000, n_terms)
    indptr = np.zeros(n_terms + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    port, ref = PlanLayoutCache(), RefCache()
    for batch in range(6):
        nq = int(rng.integers(50, 400))
        rows = rng.integers(0, n_terms, (nq, 8)).astype(np.int32)
        found = rng.random((nq, 8)) < 0.8
        natural = plan_batch(indptr, rows, found, families=FUSED_FAMILIES,
                             min_blocks=4, compact=True)
        key = ("seg", batch % 2)
        got = port.canonicalize(key, natural, nq)
        want = ref.canonicalize(key, natural, nq)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1:] == w[1:]
    assert port.stats() == ref.stats()
    assert port.to_jsonable() == ref.to_jsonable()


def _check_oracle():
    from document_search_engine_tpu.config import IndexConfig as RefC
    from document_search_engine_tpu.config import ScoringConfig as RefS
    from document_search_engine_tpu.oracle import OracleEngine as RefOracle
    from document_search_engine_tpu_torch.config import (
        IndexConfig,
        ScoringConfig,
    )
    from document_search_engine_tpu_torch.oracle import OracleEngine

    texts = _texts()
    docs, queries = texts[:60], texts[60:]
    for kind in ("tfidf", "bm25"):
        port = OracleEngine(IndexConfig(scoring=ScoringConfig(kind=kind)))
        ref = RefOracle(RefC(scoring=RefS(kind=kind)))
        for eng in (port, ref):
            eng.build(docs[:40])
            eng.add_docs(docs[40:])
        for k in (1, 10, 70):
            for g, w in zip(port.search(queries, k=k),
                            ref.search(queries, k=k)):
                np.testing.assert_array_equal(g, w)


def _check_split_planner():
    from document_search_engine_tpu.ops import schedule as ref_s
    from document_search_engine_tpu_torch.ops import schedule as port_s

    rng = np.random.default_rng(11)
    n_terms, nq, s, p = 40, 200, 8, 8
    lens_t = rng.integers(0, 5000, n_terms)
    offs = np.sort(rng.integers(0, 5000, (n_terms, p + 1)), axis=1)
    offs[:, 0], offs[:, p] = 0, lens_t
    offs = np.minimum(offs, lens_t[:, None]).astype(np.int32)
    rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
    lens = np.where(rng.random((nq, s)) < 0.7, lens_t[rows], 0)
    need = ref_s.compact_rows_per_query(lens, 1024)
    for thr in (1, 3, 40, 10**6):
        got = port_s._piece_structure(need, thr, p)
        want = ref_s._piece_structure(need, thr, p)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            port_s._piece_lens(lens, rows, offs, got[0], got[2]),
            ref_s._piece_lens(lens, rows, offs, want[0], want[2]),
        )
        for g, w in zip(port_s.split_pieces(lens, rows, offs, thr, 1024, p),
                        ref_s.split_pieces(lens, rows, offs, thr, 1024, p)):
            np.testing.assert_array_equal(g, w)


def _check_doc_quantiles():
    from document_search_engine_tpu.index import builder as ref_b
    from document_search_engine_tpu_torch.index import builder as port_b

    assert port_b.SPLIT_QUANTILES == ref_b.SPLIT_QUANTILES
    rng = np.random.default_rng(12)
    for p, n_docs in ((8, 977), (4, 10), (8, 2_000_000)):
        np.testing.assert_array_equal(port_b.quantile_doc_bounds(p, n_docs),
                                      ref_b.quantile_doc_bounds(p, n_docs))
        lens = rng.integers(0, min(200, n_docs), 30)
        lens[[3, 7]] = 0  # empty rows
        indptr = np.zeros(31, np.int64)
        np.cumsum(lens, out=indptr[1:])
        post_doc = np.concatenate([
            np.sort(rng.choice(n_docs, size=l, replace=False)) for l in lens
        ]).astype(np.int32)
        np.testing.assert_array_equal(
            port_b.host_row_doc_quantiles(indptr, post_doc, p, n_docs),
            ref_b.host_row_doc_quantiles(indptr, post_doc, p, n_docs))
    assert port_b.host_row_doc_quantiles(
        np.zeros(1, np.int64), np.zeros(0, np.int32), 8, 5).shape == (0, 9)


def _check_corpus_loader():
    import tempfile

    from document_search_engine_tpu.corpus import loader as ref_l
    from document_search_engine_tpu_torch.corpus import loader as port_l

    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        (root / "sub" / "deeper").mkdir(parents=True)
        for rel, text in (("b.txt", "beta"), ("a.text", "alpha"),
                          ("c.bin", "binary"), ("NOTES", "no suffix"),
                          ("sub/x.txt", "ex"), ("sub/deeper/.hidden", "h"),
                          ("sub/deeper/y.md", "why"), ("sub/z.txt", "")):
            (root / rel).write_text(text)
        for suffixes in ((".txt", ".text", ""), (".md",), ()):
            assert port_l.load_dir(d, suffixes) == ref_l.load_dir(
                d, suffixes), suffixes
    docs = list(range(11))
    for size in (1, 4, 11, 64):
        assert list(port_l.stream_batches(iter(docs), size)) == list(
            ref_l.stream_batches(iter(docs), size))


def _check_eval_metrics():
    from document_search_engine_tpu.eval import metrics as ref_m
    from document_search_engine_tpu_torch.eval import metrics as port_m

    rng = np.random.default_rng(21)
    results = rng.integers(-1, 30, (40, 10))
    relevant = [rng.choice(30, size=int(rng.integers(0, 6)), replace=False)
                for _ in range(40)]
    for k in (None, 1, 5):
        assert port_m.recall_at_k(results, relevant, k) == (
            ref_m.recall_at_k(results, relevant, k))
    assert port_m.mean_average_precision(results, relevant) == (
        ref_m.mean_average_precision(results, relevant))
    other = np.where(rng.random(results.shape) < 0.1, -1, results)
    assert port_m.ranking_agreement(results, other) == (
        ref_m.ranking_agreement(results, other))


def _check_eval_harness():
    from document_search_engine_tpu.eval import harness as ref_h
    from document_search_engine_tpu_torch.eval import harness as port_h
    from document_search_engine_tpu_torch.oracle import OracleEngine

    kw = dict(n_topics=4, docs_per_topic=12, topic_vocab=60,
              shared_vocab=150, mean_len=30, seed=5)
    docs, doc_topics, topics = port_h.topic_corpus(**kw)
    r_docs, r_doc_topics, r_topics = ref_h.topic_corpus(**kw)
    assert docs == r_docs
    np.testing.assert_array_equal(doc_topics, r_doc_topics)
    for t, rt in zip(topics, r_topics):
        np.testing.assert_array_equal(t, rt)
    queries, q_topics = port_h.topic_queries(topics, n_per_topic=3)
    r_queries, r_q_topics = ref_h.topic_queries(r_topics, n_per_topic=3)
    assert queries == r_queries
    np.testing.assert_array_equal(q_topics, r_q_topics)
    ora = OracleEngine()
    ora.build(docs)
    for rerank in (False, True):
        if rerank:  # the oracle has no rerank: take the port's engine
            from document_search_engine_tpu_torch import SearchEngine

            eng = SearchEngine(device="cpu")
            eng.build(docs)
        else:
            eng = ora
        got = port_h.evaluate(eng, queries, q_topics, doc_topics,
                              rerank=rerank)
        want = ref_h.evaluate(eng, queries, q_topics, doc_topics,
                              rerank=rerank)
        assert got["recall@10"] == want["recall@10"]
        assert got["map"] == want["map"]
        np.testing.assert_array_equal(got["ids"], want["ids"])
    assert port_h.parity_report(ora, ora, queries, q_topics, doc_topics) == (
        ref_h.parity_report(ora, ora, queries, q_topics, doc_topics))


def _check_delete_from_hosts():
    import copy

    from document_search_engine_tpu.config import IndexConfig as RefC
    from document_search_engine_tpu.engine.engine import (
        delete_from_hosts as ref_delete,
    )
    from document_search_engine_tpu.index import builder as ref_b
    from document_search_engine_tpu_torch.engine.engine import (
        delete_from_hosts as port_delete,
    )
    from document_search_engine_tpu_torch.index import builder as port_b
    from document_search_engine_tpu_torch.index.csr import SegmentHost

    texts = _texts()
    hosts = []
    for base, part in ((0, texts[:30]), (30, texts[30:55]),
                       (55, texts[55:])):
        a = ref_b.analyze_texts_fast(part, RefC())
        hosts.append(ref_b.build_host_segment(a, base))
    fields = ("term_hash", "df", "doc_base", "n_docs", "dl", "alive",
              "doc_hashes", "doc_tfs", "doc_ptr")
    port_hosts = [SegmentHost(**{f: copy.deepcopy(getattr(h, f))
                                 for f in fields}) for h in hosts]
    rng = np.random.default_rng(31)
    n = sum(h.n_docs for h in hosts)
    for gids in ([], [0, 0, 29, 30, n - 1, n, -1, 10**9],
                 rng.integers(-5, n + 5, 40), [0, 29, 30]):
        assert port_delete(port_hosts, gids) == ref_delete(hosts, gids)
        for ph, rh in zip(port_hosts, hosts):
            np.testing.assert_array_equal(ph.alive, rh.alive)
            np.testing.assert_array_equal(ph.df, rh.df)
            # and the recount over alive docs agrees with the original's
            r2 = copy.deepcopy(rh)
            ref_b.recompute_alive_df(r2)
            p2 = copy.deepcopy(ph)
            port_b.recompute_alive_df(p2)
            np.testing.assert_array_equal(p2.df, r2.df)
            np.testing.assert_array_equal(p2.df, ph.df)


def _check_vector_oracle():
    from document_search_engine_tpu.config import IndexConfig as RefC
    from document_search_engine_tpu.config import ScoringConfig as RefS
    from document_search_engine_tpu.oracle import (
        VectorOracleEngine as RefVector,
    )
    from document_search_engine_tpu_torch.config import (
        IndexConfig,
        ScoringConfig,
    )
    from document_search_engine_tpu_torch.oracle import VectorOracleEngine

    texts = _texts()
    docs, queries = texts[:60], texts[60:]
    for kind in ("tfidf", "bm25"):
        port = VectorOracleEngine(IndexConfig(scoring=ScoringConfig(
            kind=kind)))
        ref = RefVector(RefC(scoring=RefS(kind=kind)))
        for eng in (port, ref):
            eng.build(docs[:40])
            eng.add_docs(docs[40:])
            eng.delete_docs([1, 41])
        for k in (1, 10, 70):
            for g, w in zip(port.search(queries, k=k),
                            ref.search(queries, k=k)):
                np.testing.assert_array_equal(g, w)


def _check_schedule_block_plan():
    from document_search_engine_tpu.ops import schedule as ref_s
    from document_search_engine_tpu_torch.ops import schedule as port_s

    rng = np.random.default_rng(13)
    lens = rng.integers(0, 9000, 50)
    indptr = np.zeros(51, np.int64)
    np.cumsum(lens, out=indptr[1:])
    for nq, s in ((0, 8), (1, 3), (300, 8)):
        rows = rng.integers(0, 50, (nq, s)).astype(np.int32)
        found = rng.random((nq, s)) < 0.8
        for block in (128, 512, 2048, 4096):
            assert port_s.block_plan(indptr, rows, found, block) == (
                ref_s.block_plan(indptr, rows, found, block))
            np.testing.assert_array_equal(
                port_s.blocks_per_query(indptr, rows, found, block),
                ref_s.blocks_per_query(indptr, rows, found, block))


@pytest.mark.parametrize("module", [
    "tokenizer_and_hasher", "native_analyzer", "plan_cache", "oracle",
    "split_planner", "doc_quantiles", "corpus_loader", "eval_metrics",
    "eval_harness", "delete_from_hosts", "vector_oracle",
    "schedule_block_plan",
])
def test_host_module_copy_matches_original(module):
    {
        "tokenizer_and_hasher": _check_tokenizer_and_hasher,
        "native_analyzer": _check_native_analyzer,
        "plan_cache": _check_plan_cache,
        "oracle": _check_oracle,
        "split_planner": _check_split_planner,
        "doc_quantiles": _check_doc_quantiles,
        "corpus_loader": _check_corpus_loader,
        "eval_metrics": _check_eval_metrics,
        "eval_harness": _check_eval_harness,
        "delete_from_hosts": _check_delete_from_hosts,
        "vector_oracle": _check_vector_oracle,
        "schedule_block_plan": _check_schedule_block_plan,
    }[module]()
