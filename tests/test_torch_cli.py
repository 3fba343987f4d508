"""The torch port's CLI and its host copies (CPU): index -> search,
search --rerank, serve on a stdin stream and eval, at --device cpu, with
the printed hits equal to the library's on the saved index; the card is
the default device; what is not ported yet (index --shards, a sharded
checkpoint, bench) raises NotImplementedError naming its ROADMAP item;
the corpus loader and the eval metrics."""
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
def test_cli_refuses_what_is_not_ported(what, tmp_path, capsys):
    if what == "index_shards":
        argv = ["index", str(_corpus_dir(tmp_path)), "--out",
                str(tmp_path / "x"), "--shards", "2", "--device", "cpu"]
        item = "A13"
    elif what == "sharded_index":
        idx = _index(tmp_path, capsys)
        with open(f"{idx}/meta.json") as f:
            meta = json.load(f)
        meta["sharded"] = True
        with open(f"{idx}/meta.json", "w") as f:
            json.dump(meta, f)
        argv = ["search", idx, "apples", "--device", "cpu"]
        item = "A13"
    else:
        argv, item = ["bench"], "A6"
    with pytest.raises(NotImplementedError, match=item):
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
