"""The benchmark's CPU tests. ``cuda``-marked tests need an NVIDIA card;
the ``card`` fixture skips them where there is none (decided when the test
runs, never when the module is imported)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips where CUDA is absent")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    from perfbench.tests import tiny

    tmp = tmp_path_factory.mktemp("bench")
    return tiny.make(tmp), tmp / "bench"
