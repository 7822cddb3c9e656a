"""The benchmark's tests: CPU tests of its generator, arithmetic,
discovery, result line and imports, tiny CPU runs of every cell's driver
under planted faults, and ``cuda`` tests that read the control on the
card.  Run them with ``python -m pytest benchmark/tests``."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, not at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
