"""The benchmark's own tests (``python -m pytest benchmark/tests``).  Tests
that need the card carry the ``cuda`` marker and skip, inside a fixture,
where there is none."""
from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [p for p in (BENCH, os.path.dirname(BENCH)) if p not in sys.path]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")
