"""The benchmark's own tests: run from the repository root with
`python -m pytest benchmark/tests -q`. They import neither JAX nor the
JAX package. Tests that need the card carry the `cuda` marker and ask
for the `card` fixture, which skips without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the smallest fleet the CPU rehearsals run: 16 VAs, one model each
TINY = {"variants": 16, "models": 16, "namespaces": 4}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips on a host without CUDA")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (this host has none)")
    return torch.device("cuda")
