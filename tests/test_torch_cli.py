"""The torch port's CLI and its host copies (CPU): index -> search,
search --rerank, serve on a stdin stream and eval, at --device cpu, with
the printed hits equal to the library's on the saved index, for a single engine and for a
2-shard index (index --shards 2, then search and serve on the sharded
checkpoint); bench at --device cpu with tiny BENCH_* knobs, every leg
on, printing its one JSON line; the card is the default device (bench
included); the commands refused until their modules were ported (the
sharded ones, bench) now run; the corpus loader and the eval
metrics."""
import io
import json
import re
import sys

import numpy as np
import pytest
import torch

from document_search_engine_tpu_torch import SearchEngine
from document_search_engine_tpu_torch.cli import main
from document_search_engine_tpu_torch.corpus.loader import (
    load_dir,
    stream_batches,
)
from document_search_engine_tpu_torch.eval.metrics import (
    mean_average_precision,
    ranking_agreement,
    recall_at_k,
)

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)

HIT = re.compile(r"^\s*(\d+)\. (\S+)  score=([0-9.]+)(?:  rerank=\S+)?"
                 r"  \(doc (\d+)\)$")


def _corpus_dir(tmp_path):
    d = tmp_path / "corpus"
    d.mkdir()
    (d / "one.txt").write_text("apples and oranges are fruit")
    (d / "two.txt").write_text("cars and trucks are vehicles")
    (d / "three.txt").write_text("apples grow on trees")
    (d / "four.txt").write_text("apples apples and cars")
    return d


def _index(tmp_path, capsys):
    idx = str(tmp_path / "idx")
    assert main(["index", str(_corpus_dir(tmp_path)), "--out", idx,
                 "--kind", "bm25", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["docs"] == 4 and out["out"] == idx
    return idx


def test_cli_end_to_end(tmp_path, capsys, monkeypatch):
    idx = _index(tmp_path, capsys)
    with open(f"{idx}/docnames.json") as f:
        names = json.load(f)
    assert names == ["four.txt", "one.txt", "three.txt", "two.txt"]
    eng = SearchEngine.load(idx, device="cpu")
    sb = eng.config.scoring.scale_bits
    queries = ["apples", "cars trucks", "nothing here"]
    ids, scores = eng.search(queries, k=3)
    for qi, q in enumerate(queries):
        assert main(["search", idx, q, "-k", "3", "--device", "cpu"]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        got = [HIT.match(ln).groups() for ln in lines]
        want = [(str(r), names[g], f"{s / (1 << sb):.6f}", str(g))
                for r, (g, s) in enumerate(zip(ids[qi], scores[qi]), 1)
                if g >= 0]
        assert got == want, q
    assert main(["search", idx, "apples", "-k", "2", "--rerank",
                 "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    r_ids, _ri, _lex = eng.search_rerank(["apples"], k=2)
    assert [int(HIT.match(ln).group(4)) for ln in lines] == [
        g for g in r_ids[0] if g >= 0]
    assert all("rerank=" in ln for ln in lines)
    # pipelined stdin serving, two batches of one
    monkeypatch.setattr(sys, "stdin", io.StringIO("apples\n\ncars trucks\n"))
    assert main(["serve", idx, "-k", "3", "--batch", "1",
                 "--device", "cpu"]) == 0
    lines = [json.loads(ln)
             for ln in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 2
    for qi, line in enumerate(lines):
        want = [{"doc": int(g), "score": float(s) / (1 << sb)}
                for g, s in zip(ids[qi], scores[qi]) if g >= 0]
        assert line["hits"] == want


@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_cli_eval(kind, capsys):
    assert main(["eval", "--kind", kind, "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ranking_agreement"] == 1.0 and rep["engine"] == rep["oracle"]
    # every top-10 hit on topic: the ceiling with 40 docs a topic
    assert rep["engine"] == {"recall@10": 0.25, "map": 0.25}


def test_cli_runs_on_the_card_by_default(tmp_path, capsys, monkeypatch):
    """Without --device every command means the card: without CUDA it
    raises rather than running elsewhere."""
    idx = _index(tmp_path, capsys)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["index", str(tmp_path / "corpus"), "--out", idx],
                 ["search", idx, "apples"], ["eval"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)


@pytest.mark.parametrize("what", ["index_shards", "sharded_index", "bench"])
def test_cli_refuses_what_is_not_ported(what, tmp_path, capsys,
                                        monkeypatch):
    """Each of these was refused with NotImplementedError until its
    module was ported, and now runs: index --shards and a sharded
    checkpoint (the sharded engine), and bench (the port's benchmark),
    which like every command means the card without --device, and so
    raises "CUDA is not available" on a machine without one."""
    if what == "bench":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["bench"])
        return
    idx = str(tmp_path / "x")
    assert main(["index", str(_corpus_dir(tmp_path)), "--out", idx,
                 "--shards", "2", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["docs"] == 4
    if what == "sharded_index":
        assert main(["search", idx, "apples", "--device", "cpu"]) == 0
        assert HIT.match(capsys.readouterr().out.splitlines()[0])


BENCH_TINY = {
    "BENCH_DOCS": "3000", "BENCH_NQ": "32", "BENCH_ITERS": "2",
    "BENCH_BATCHES": "2", "BENCH_PASSES": "2", "BENCH_BUILD": "1",
    "BENCH_BUILD_DEVICE": "1", "BENCH_SHARDS": "1", "BENCH_PACK": "1",
    "BENCH_8M": "1", "BENCH_8M_DOCS": "4000", "BENCH_8M_PASSES": "1",
    "BENCH_STREAM": "1", "BENCH_STREAM_DOCS": "2000",
    "BENCH_STREAM_BATCH": "400",
}
BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "median", "passes",
    "compile_warmup_secs", "levers", "hbm_bytes", "n_docs", "step_qps",
    "sharded", "sharded_qps_1shard", "device_pack_secs",
    "build_docs_per_sec_host", "m8", "stream",
}


def test_cli_bench_on_cpu(capsys, monkeypatch):
    """bench --device cpu at tiny BENCH_* sizes with every leg on prints
    exactly one line on stdout, the JSON object of bench.py's keys (its
    tunnel probes and cooldown aside), no leg null."""
    for key, val in BENCH_TINY.items():
        monkeypatch.setenv(key, val)
    assert main(["bench", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    res = json.loads(lines[0])
    assert set(res) == BENCH_KEYS
    assert not [key for key, val in res.items() if val is None], res
    assert res["metric"] == "queries_per_sec_per_chip" and res["unit"] == "qps"
    assert res["n_docs"] == 3000 and len(res["passes"]) == 2
    assert res["value"] == max(res["passes"]) > 0
    assert res["levers"]["scorer"] == "xla" and res["levers"]["nq"] == 32
    assert res["step_qps"] > 0 and res["device_pack_secs"] > 0
    assert res["build_docs_per_sec_host"] > 0 and res["hbm_bytes"] > 0
    assert len(res["sharded"]["passes"]) == 5
    assert res["sharded_qps_1shard"] == res["sharded"]["best"]
    assert res["m8"]["n_docs"] == 4000 and res["m8"]["step_qps"] > 0
    assert res["m8"]["hbm_bytes"] > 0
    assert res["stream"]["n_docs"] == 2000 and res["stream"]["batches"] == 5
    assert res["stream"]["segments"] == 1  # auto-compacted past 4


def test_cli_sharded_index_search_and_serve(tmp_path, capsys, monkeypatch):
    """index --shards 2 --device cpu writes a sharded checkpoint; search
    (plain and --rerank) and serve on it print the hits of
    DistributedSearchEngine.load on the same index, which equal a single
    engine's; without --device the sharded commands mean the card."""
    from document_search_engine_tpu_torch import DistributedSearchEngine
    from document_search_engine_tpu_torch.parallel.mesh import make_mesh

    idx = str(tmp_path / "sidx")
    assert main(["index", str(_corpus_dir(tmp_path)), "--out", idx,
                 "--shards", "2", "--kind", "bm25", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["docs"] == 4 and out["out"] == idx
    with open(f"{idx}/meta.json") as f:
        meta = json.load(f)
    assert meta["sharded"] and meta["n_shards"] == 2
    with open(f"{idx}/docnames.json") as f:
        names = json.load(f)
    eng = DistributedSearchEngine.load(idx, mesh=make_mesh(2, device="cpu"))
    sb = eng.config.scoring.scale_bits
    queries = ["apples", "cars trucks", "nothing here"]
    ids, scores = eng.search(queries, k=3)
    (tmp_path / "single").mkdir()
    single = SearchEngine.load(_index(tmp_path / "single", capsys),
                               device="cpu")
    s_ids, s_scores = single.search(queries, k=3)
    np.testing.assert_array_equal(ids, s_ids)
    np.testing.assert_array_equal(scores, s_scores)
    for qi, q in enumerate(queries):
        assert main(["search", idx, q, "-k", "3", "--device", "cpu"]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        got = [HIT.match(ln).groups() for ln in lines]
        want = [(str(r), names[g], f"{s / (1 << sb):.6f}", str(g))
                for r, (g, s) in enumerate(zip(ids[qi], scores[qi]), 1)
                if g >= 0]
        assert got == want, q
    assert main(["search", idx, "apples", "-k", "2", "--rerank",
                 "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    r_ids, _ri, _lex = eng.search_rerank(["apples"], k=2)
    assert [int(HIT.match(ln).group(4)) for ln in lines] == [
        g for g in r_ids[0] if g >= 0]
    monkeypatch.setattr(sys, "stdin", io.StringIO("apples\n\ncars trucks\n"))
    assert main(["serve", idx, "-k", "3", "--batch", "1",
                 "--device", "cpu"]) == 0
    lines = [json.loads(ln)
             for ln in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 2
    for qi, line in enumerate(lines):
        want = [{"doc": int(g), "score": float(s) / (1 << sb)}
                for g, s in zip(ids[qi], scores[qi]) if g >= 0]
        assert line["hits"] == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["index", str(tmp_path / "corpus"), "--out", idx,
                  "--shards", "2"], ["search", idx, "apples"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)


def test_corpus_loader(tmp_path):
    d = tmp_path / "corpus"
    d.mkdir()
    (d / "b.txt").write_text("beta content")
    (d / "a.txt").write_text("alpha content")
    (d / "skip.bin").write_text("not a text file")
    sub = d / "sub"
    sub.mkdir()
    (sub / "c.txt").write_text("gamma content")
    (sub / "README").write_text("no suffix")
    docs = load_dir(str(d))
    assert [n for n, _ in docs] == ["a.txt", "b.txt", "sub/README",
                                    "sub/c.txt"]
    assert docs[0][1] == "alpha content"
    batches = list(stream_batches(docs, batch_size=3))
    assert [len(b) for b in batches] == [3, 1]
    assert list(stream_batches([], batch_size=3)) == []


def test_metrics():
    results = np.array([[3, 1, -1], [9, 9, 9]])
    relevant = [[3, 7], [1]]
    assert recall_at_k(results, relevant) == 0.25
    ap = mean_average_precision(results, relevant)
    assert 0.24 < ap < 0.26  # AP(q0) = (1/1) / 2 = 0.5; AP(q1) = 0
    assert ranking_agreement(results, results) == 1.0
    assert ranking_agreement(results, results[::-1]) == 0.0
