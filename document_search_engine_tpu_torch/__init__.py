"""document_search_engine_tpu_torch — the lexical retrieval stack on
PyTorch and CUDA (one NVIDIA H100), ported from the JAX package
`document_search_engine_tpu`, which stays the reference.

The port imports torch and never jax, and nothing of the JAX package:
it keeps its own copies of the host modules it needs (config, analyzer,
native library bindings, oracle and spec, plan-layout cache, corpora,
eval) under the same relative paths. It serves the JAX package's single
engine and its sharded one (`DistributedSearchEngine` over a `docs` mesh
of torch devices, `make_mesh`): build and streaming build,
add/delete/compact, save/load (v2 checkpoints that either package
opens), search, rerank, and the CLI
(`python -m document_search_engine_tpu_torch`); the reference scorers
(ops/exact.py, ops/topk.py, ops/packed.py), the vectorized oracle, the
phase timers and trace (utils/prof.py) and the entry points
(`python -m document_search_engine_tpu_torch.entry`). The fused search step and the
rerank dots are hand-written CUDA kernels (csrc/), built with nvcc at
first use. `SearchEngine()` and `DistributedSearchEngine()` run on the
card unless given `device="cpu"` (`make_mesh(n, device="cpu")`).
"""
from .engine.engine import SearchEngine
from .config import AnalyzerConfig, IndexConfig, ScoringConfig
from .parallel.dist import DistributedSearchEngine
from .parallel.mesh import make_mesh

__all__ = [
    "AnalyzerConfig", "DistributedSearchEngine", "IndexConfig",
    "ScoringConfig", "SearchEngine", "make_mesh",
]
