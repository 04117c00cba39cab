"""Shared set-up of the benchmark's own tests (``pytest snpbench/tests``).

The benchmark's folder and the checkout's ``src/`` go on the path; tests
that need a CUDA card carry the ``card`` marker and skip without one,
deciding inside the test (the :func:`card` fixture).
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    import torch
    torch.set_num_threads(1)
