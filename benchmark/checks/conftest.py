"""Settings of the benchmark's own checks: the repository root on the
path, and the marker of checks that need an NVIDIA card (they skip here
with the reason; on the card: python -m pytest -m cuda benchmark/checks)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
