"""The benchmark's own tests: the harness's parts on the CPU, and a short
run of each cell on the card (marked ``cuda``; it skips without one).

    python3 -m pytest benchmark/tests -q            # here, on the CPU
    python3 -m pytest benchmark/tests -q -m cuda    # on a machine with a card
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() is False",
    )


@pytest.fixture
def card():
    """Skip unless a CUDA card is there: decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
