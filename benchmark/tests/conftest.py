"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests marked ``card`` need a CUDA device; the ``card`` fixture skips them
elsewhere, deciding when the test runs, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (the H100)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
