"""The port's entry points (entry.py) against the JAX package's
(`__graft_entry__.py`), its dry run's ranking check, and its phase
timers and trace (utils/prof.py) with the engine's phases."""
import json

import jax
import numpy as np
import pytest
import torch

from document_search_engine_tpu_torch import entry as port_entry
from document_search_engine_tpu_torch.ops.rank import rank_kernel
from document_search_engine_tpu_torch.utils import prof

# the suite runs several workers on shared cores: one thread each keeps
# torch's intra-op pools from fighting over them
torch.set_num_threads(1)


def test_entry_matches_reference_entry():
    """The packed step (pack_ds, then the rank-only kernel's wrapper,
    which takes its plain version on CPU tensors) == the reference's
    jitted search_packed_ds step on the same toy engine and queries."""
    import __graft_entry__ as ref_entry

    fn, args = port_entry.entry(device="cpu")
    launches = rank_kernel.launches
    vals, gids = fn(*args)
    assert rank_kernel.launches == launches
    assert vals.shape == gids.shape == (8, 10)
    assert vals.dtype == gids.dtype == torch.int32
    assert (vals[:, 0] > 0).all()  # self-queries must match something
    ref_fn, ref_args = ref_entry.entry()
    ref_vals, ref_gids = jax.jit(ref_fn)(*ref_args)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))
    np.testing.assert_array_equal(gids.numpy(), np.asarray(ref_gids))


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_dryrun_multichip_on_cpu_meshes(n_shards, capsys):
    port_entry.dryrun_multichip(n_shards, device="cpu")
    assert "dryrun_multichip OK" in capsys.readouterr().out


def test_dryrun_fails_on_a_shifted_ranking(monkeypatch):
    """The dry run holds the ranking against the oracle: an oracle whose
    results are shifted by one rank makes it raise."""

    class Shifted(port_entry.OracleEngine):
        def search(self, queries, k=10):
            ids, scores = super().search(queries, k=k)
            return np.roll(ids, 1, axis=1), np.roll(scores, 1, axis=1)

    monkeypatch.setattr(port_entry, "OracleEngine", Shifted)
    with pytest.raises(AssertionError):
        port_entry.dryrun_multichip(2, device="cpu")


def test_entry_points_mean_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.dryrun_multichip(2)


def test_prof_utils(tmp_path):
    """The reference's test_prof_utils, plus sync on CPU tensors and a
    trace written on the CPU."""
    prof.reset()
    with prof.phase("build"):
        pass
    with prof.phase("search", sync_on=(torch.ones(2), 1)):
        pass
    rec = json.loads(prof.metrics_json(extra_field=1))
    assert set(rec["phases_s"]) == {"build", "search"}
    assert rec["counts"] == {"build": 1, "search": 1}
    assert rec["extra_field"] == 1
    prof.sync(torch.zeros(3))
    prof.sync([torch.zeros(3)])
    path = tmp_path / "trace.json"
    with prof.trace(str(path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads(path.read_text())["traceEvents"]
    assert events
    prof.reset()
    assert json.loads(prof.metrics_json())["phases_s"] == {}


def test_engine_records_only_the_reference_phases():
    """The single engine records build.analyze (add_docs, build) and
    search.analyze / search.score (search), as the JAX engine does, and
    nothing else: not the streaming build, search_stream, the lifecycle
    or the sharded engine."""
    from document_search_engine_tpu_torch import (
        DistributedSearchEngine,
        SearchEngine,
        make_mesh,
    )
    from document_search_engine_tpu_torch.corpus.synth import (
        synth_corpus,
        synth_queries,
    )

    docs = synth_corpus(n_docs=40, vocab_size=200, mean_len=20, seed=3)
    queries = synth_queries(docs, n_queries=5, seed=4)
    prof.reset()
    eng = SearchEngine(device="cpu")
    eng.build(docs[:30])
    eng.add_docs(docs[30:])
    eng.search(queries, k=5)
    counts = json.loads(prof.metrics_json())["counts"]
    assert counts == {"build.analyze": 2, "search.analyze": 1,
                      "search.score": 1}
    eng.build_streaming([docs[:20], docs[20:]])
    list(eng.search_stream([queries], k=5))
    eng.delete_docs([0, 3])
    eng.compact()
    dist = DistributedSearchEngine(mesh=make_mesh(2, device="cpu"))
    dist.build(docs)
    dist.search(queries, k=5)
    assert json.loads(prof.metrics_json())["counts"] == counts
    prof.reset()
