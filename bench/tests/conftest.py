"""Shared plumbing of the benchmark's CPU tests: the ``cuda`` marker, tiny
copies of each cell that run the harness on the CPU, and the card."""
from __future__ import annotations

import pytest

from bench.tests.tiny import REPO, tiny


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the CUDA kernels); skips inside "
        "the test where torch.cuda.is_available() is false")


@pytest.fixture
def tiny_cell():
    from bench import harness

    return lambda name: tiny(harness.load_cell(name, REPO))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
