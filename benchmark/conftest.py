"""pytest settings of the benchmark's own tests (benchmark/tests/).

    python -m pytest benchmark/tests -q

The tests that need a CUDA card carry the one marker `card`; each decides
in its `card` fixture whether a card is present and skips on the CPU."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
for path in (str(BENCH), str(BENCH.parent)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped on the CPU")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark measures the port on "
                    "the H100); this machine has none")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _workdir(tmp_path, monkeypatch):
    """Run each test in its own directory: Pyro writes its parameter file
    (inputs.auto) to the working directory."""
    monkeypatch.chdir(tmp_path)
