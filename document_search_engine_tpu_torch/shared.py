"""Every module of the reference package that the port uses as it is.

They are its jax-free host modules: the configs, the tokenizer, term
hasher and native analyzer library, the oracle spec and frozen CPU
oracle (the parity reference), the plan-layout cache and the synthetic
corpora. None of them imports jax. The port reaches the reference only
through this module.
"""
from document_search_engine_tpu.analyze import native
from document_search_engine_tpu.analyze.hashing import TermHasher
from document_search_engine_tpu.analyze.tokenizer import Tokenizer
from document_search_engine_tpu.config import (
    AnalyzerConfig,
    IndexConfig,
    ScoringConfig,
)
from document_search_engine_tpu.corpus.synth import synth_corpus, synth_queries
from document_search_engine_tpu.oracle import OracleEngine, spec
from document_search_engine_tpu.ops.plan_cache import PlanLayoutCache

__all__ = [
    "AnalyzerConfig", "IndexConfig", "OracleEngine", "PlanLayoutCache",
    "ScoringConfig", "TermHasher", "Tokenizer", "native", "spec",
    "synth_corpus", "synth_queries",
]
