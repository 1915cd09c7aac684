"""Tests of the benchmark's harness (`python -m pytest luwbench/tests`).

They drive every cell's path at a tiny size on the CPU, where the port runs
its kernels' plain versions.  Tests marked `card` run the command itself on
an NVIDIA card and skip, inside the `card` fixture, without one.
"""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark measures the card")
    return torch.cuda.device_count()


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
