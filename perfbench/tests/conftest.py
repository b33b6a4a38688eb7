"""The benchmark's own tests: ``python -m pytest perfbench/tests -q`` from the
root of the repository (about half a minute on the CPU). Tests marked ``cuda``
need the card and skip without one; on the card, ``-m cuda`` runs them."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test drives the benchmark on the card")
    return torch.device("cuda")
