"""The benchmark's own tests: `python -m pytest verifier_bench/tests -q`
from the checkout's root (CPU; a few minutes).  Tests marked `card` need a
CUDA card; without one they skip, decided inside the `card` fixture."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's card path runs only there")
    return "cuda"


@pytest.fixture(scope="session")
def root():
    return ROOT
