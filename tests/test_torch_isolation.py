"""The torch port stands without jax: it imports, builds and serves in a
process where importing jax fails; no module of the port imports jax;
asking for a CUDA engine without CUDA raises; and the kernel wrapper
takes its plain version for CPU tensors without counting a launch."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "document_search_engine_tpu_torch"

_BLOCKED_RUN = r"""
import sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked in this process")
        return None

sys.meta_path.insert(0, BlockJax())
from document_search_engine_tpu_torch import IndexConfig, SearchEngine
from document_search_engine_tpu_torch.shared import OracleEngine

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
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
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
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib"), (
                    f"{path.relative_to(REPO)}:{node.lineno} imports {name}"
                )


def test_cuda_engine_without_cuda_raises(monkeypatch):
    from document_search_engine_tpu_torch import SearchEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SearchEngine(device="cuda")


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
    launches = fused.fused_search.launches
    got = fused.fused_search(
        d2, v2, *tabs, n_blocks=8, block=256, s=2, k=5, n_docs=n_docs,
        scale=65536.0, clip=65075262.0, r_c=16, key_bits=1,
    )
    want = search_packed_tables(
        d2, v2, *tabs[:3], 65536.0, 65075262.0, 0, n_blocks=8, block=256,
        s=2, k=5, n_docs=n_docs,
    )
    assert fused.fused_search.launches == launches
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert (got[0] > 0).any()
