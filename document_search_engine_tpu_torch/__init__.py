"""document_search_engine_tpu_torch — the lexical retrieval stack on
PyTorch and CUDA (one NVIDIA H100), ported from the JAX package
`document_search_engine_tpu`, which stays the reference.

The port imports torch and never jax, and nothing of the JAX package:
it keeps its own copies of the host modules it needs (config, analyzer,
native library bindings, oracle and spec, plan-layout cache, corpora,
eval) under the same relative paths. It serves the JAX package's single
engine: build and streaming build, add/delete/compact, save/load (v2
checkpoints that either package opens), search, rerank, and the CLI
(`python -m document_search_engine_tpu_torch`). The fused search step and the
rerank dots are hand-written CUDA kernels (csrc/), built with nvcc at
first use. `SearchEngine()` runs on the card unless given
`device="cpu"`.
"""
from .engine.engine import SearchEngine
from .config import AnalyzerConfig, IndexConfig, ScoringConfig

__all__ = ["AnalyzerConfig", "IndexConfig", "ScoringConfig", "SearchEngine"]
