"""CPU tests of the benchmark (``python -m pytest benchmark/tests``).

Tests that need the card carry the ``card`` marker and skip, with their
reason, on a host without one; whether there is a card is decided inside
the ``card`` fixture, never while a module is imported.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda", 0)
