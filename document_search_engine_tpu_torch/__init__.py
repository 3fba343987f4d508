"""document_search_engine_tpu_torch — the lexical retrieval stack on
PyTorch and CUDA (one NVIDIA H100), ported from the JAX package
`document_search_engine_tpu`, which stays the reference.

The port imports torch and never jax. It shares the reference's
jax-free host modules (config, analyzer, native library, oracle spec,
plan-layout cache) instead of copying them, and reaches them only
through `shared`. The fused search step is a hand-written CUDA kernel
(csrc/fused_search.cu), built with nvcc at first use.
"""
from .engine.engine import SearchEngine
from .shared import AnalyzerConfig, IndexConfig, ScoringConfig

__all__ = ["AnalyzerConfig", "IndexConfig", "ScoringConfig", "SearchEngine"]
