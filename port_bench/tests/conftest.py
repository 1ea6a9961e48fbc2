"""Settings of the benchmark's own tests: the ``card`` marker and the
fixtures."""

from __future__ import annotations

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skip the test where there is no CUDA card (decided here, when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def data_root(tmp_path_factory):
    """Where the tiny cells' corpora are written."""
    return tmp_path_factory.mktemp("port_bench_data")
