"""The benchmark's own tests: run from the root of the checkout with
``python -m pytest bench_port/tests -q``.  Tests that need a CUDA device
carry the ``cuda`` marker and skip without one, decided in the
``cuda_device`` fixture, never at import."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark times the card")
    return "cuda"
