"""CPU tests of the benchmark harness; `card` tests run only on a CUDA
machine and skip elsewhere (decided inside the fixture, at run time)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    torch.set_num_threads(1)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
