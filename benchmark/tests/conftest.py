"""CPU tests of the benchmark: ``python -m pytest benchmark/tests -q``.

They import the port (``pothoscomms_tpu_torch``) on the CPU and never the
JAX package. Tests that need the card carry the ``cuda`` marker and decide
inside the test whether to skip."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped without one")


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark at sizes a CPU run holds."""
    from bench_helpers import make_tiny_root

    return make_tiny_root(tmp_path)
