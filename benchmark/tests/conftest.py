"""Settings of the benchmark's tests: the ``gpu`` marker for tests that
need a CUDA card (they skip without one, decided inside the ``card``
fixture, never at import), and few CPU threads for the CPU rehearsals."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; run on the card with "
        "python -m pytest -m gpu benchmark/tests")


@pytest.fixture(autouse=True, scope="session")
def _threads():
    torch.set_num_threads(min(4, torch.get_num_threads()))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
