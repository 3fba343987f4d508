"""Eval harness (SURVEY.md §4/§5): topic-corpus retrieval quality + parity.

The environment has no network egress, so the 20-Newsgroups-style gate
(BASELINE.json:8) runs on a deterministic synthetic topic corpus: each
topic gets a private vocabulary mixed with a shared background vocabulary;
relevance(query) = docs of the query's topic. TF-IDF vs BM25 recall@10 /
MAP are computed for the engine and the oracle — parity requires the
engine's metrics to equal the oracle's exactly (rankings are
bit-identical), and absolute quality to clear a sanity floor.

The torch port's own copy of `document_search_engine_tpu/eval/harness.py`,
kept identical in behaviour (tests/test_torch_isolation.py holds the
two against each other); the port imports nothing of the JAX
package.
"""
from __future__ import annotations

import numpy as np

from ..corpus.synth import make_vocab
from .metrics import mean_average_precision, ranking_agreement, recall_at_k


def topic_corpus(
    n_topics: int = 8,
    docs_per_topic: int = 40,
    topic_vocab: int = 150,
    shared_vocab: int = 400,
    mean_len: int = 60,
    topic_frac: float = 0.5,
    seed: int = 0,
):
    """(docs, doc_topics, topic_vocabs)."""
    rng = np.random.default_rng(seed)
    shared = np.array(make_vocab(shared_vocab, seed=seed + 1))
    topics = []
    all_words = set(shared.tolist())
    t_seed = seed + 2
    while len(topics) < n_topics:
        cand = make_vocab(topic_vocab, seed=t_seed)
        t_seed += 1
        cand = [w for w in cand if w not in all_words]
        if len(cand) >= topic_vocab // 2:
            topics.append(np.array(cand))
            all_words.update(cand)
    docs, doc_topics = [], []
    for t in range(n_topics):
        for _ in range(docs_per_topic):
            length = max(8, int(rng.poisson(mean_len)))
            n_topic_words = int(length * topic_frac)
            words = np.concatenate(
                [
                    rng.choice(topics[t], n_topic_words),
                    rng.choice(shared, length - n_topic_words),
                ]
            )
            rng.shuffle(words)
            docs.append(" ".join(words))
            doc_topics.append(t)
    return docs, np.array(doc_topics), topics


def topic_queries(topics, n_per_topic: int = 5, terms: int = 4, seed: int = 9):
    rng = np.random.default_rng(seed)
    queries, q_topics = [], []
    for t, tv in enumerate(topics):
        for _ in range(n_per_topic):
            queries.append(" ".join(rng.choice(tv, size=terms, replace=False)))
            q_topics.append(t)
    return queries, np.array(q_topics)


def evaluate(engine, queries, q_topics, doc_topics, k: int = 10,
             rerank: bool = False):
    if rerank:
        ids, _ri, _lex = engine.search_rerank(queries, k=k)
    else:
        ids, _ = engine.search(queries, k=k)
    relevant = [
        np.nonzero(doc_topics == t)[0].tolist() for t in q_topics
    ]
    return {
        "recall@10": recall_at_k(np.asarray(ids), relevant, k=k),
        "map": mean_average_precision(np.asarray(ids), relevant),
        "ids": np.asarray(ids),
    }


def parity_report(engine, oracle, queries, q_topics, doc_topics, k=10):
    e = evaluate(engine, queries, q_topics, doc_topics, k)
    o = evaluate(oracle, queries, q_topics, doc_topics, k)
    return {
        "engine": {m: e[m] for m in ("recall@10", "map")},
        "oracle": {m: o[m] for m in ("recall@10", "map")},
        "ranking_agreement": ranking_agreement(e["ids"], o["ids"]),
    }
