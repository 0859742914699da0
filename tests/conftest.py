"""Pytest settings shared by the test suite: marker registration only."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; the test skips itself when none is present",
    )
