"""The benchmark's tests: on the CPU through the program's plain versions,
and one marker, ``card``, for those that need a CUDA card (they skip
without one; the check is made in a fixture, never at import)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (runs the benchmark on it)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card")
    return torch.cuda.get_device_name(0)


@pytest.fixture(autouse=True)
def few_threads():
    """Each benchmark test on two of the host's threads: the suite runs on
    several workers at once."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
