"""The tiled_pair_share reader: its entry, nothing read from an empty
registry or from a program that counts no `step.tiled_pairs` (the
parent of the counter), and the share from a registry filled by hand."""
import pytest

from benchmark.registry import Registry
from document_search_engine_tpu_torch.utils import prof

NAME = "tiled_pair_share"


@pytest.fixture(autouse=True)
def _clean_registry():
    prof.reset()
    yield
    prof.reset()


def test_its_entry_and_reader():
    reg = Registry()
    entry = {m["name"]: m for m in reg.spec["per_layer"]}[NAME]
    assert (entry["layer"], entry["moves"], entry["unit"]) == (
        "kernels", "qps", "%")
    assert "workloads" not in entry
    assert callable(reg.reader(NAME))


@pytest.mark.parametrize("counts", [{}, {"step.pairs": 10},
                                    {"step.tiled_pairs": 5},
                                    {"step.pairs": 0, "step.tiled_pairs": 0}])
def test_nothing_to_read(counts):
    for name, n in counts.items():
        prof.count(name, n)
    assert Registry().reader(NAME)({}) is None


def test_the_share_of_the_window():
    for pairs, tiled in ((600, 570), (400, 0)):
        prof.count("step.pairs", pairs)
        prof.count("step.tiled_pairs", tiled)
    assert Registry().reader(NAME)({}) == pytest.approx(57.0)
