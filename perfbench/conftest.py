"""Pytest settings of the benchmark's own tests: the ``gpu`` marker, the
fixture that decides, when a test runs, whether there is a card, and the
overrides that shrink a cell to a size the CPU holds."""
import pytest

def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; the test skips itself when none is present",
    )


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures only on the card")
    return torch.device("cuda")


@pytest.fixture
def small():
    """Overrides that shrink a cell to a size the CPU tests hold."""
    return {"config": {"sub_bytes": 256},
            "mix": {"pool_stripes": 2, "check_sample": 2, "rate_per_s": 200}}
