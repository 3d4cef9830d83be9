"""CPU tests of the benchmark (and, marked cuda, one on the card):

    python -m pytest -q benchmark/tests
    python -m pytest -q -m cuda benchmark/tests     # on a machine with a card
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture(autouse=True)
def _cache(tmp_path_factory, monkeypatch):
    """Deployments of the tests' tiny configurations in the test run's
    temporary directory, never in the checkout's cache."""
    from kbench import deploy

    monkeypatch.setattr(deploy, "CACHE_DIR",
                        str(tmp_path_factory.getbasetemp() / "bench-cache"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
