"""Tests of the port's benchmark.  Those marked ``cuda`` need an NVIDIA
card and skip without one; run them on the card with

    python -m pytest benchmark/tests -m cuda -p no:cacheprovider
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
