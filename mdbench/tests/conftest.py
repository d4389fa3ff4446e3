"""pytest settings of the benchmark's own tests (``python -m pytest
mdbench/tests -q`` from the repository root). Tests that need a CUDA card
carry the ``cuda`` marker and take the ``cuda_device`` fixture, which skips
them on a host without one; the decision is made in the fixture, never at
import."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return "cuda"
