"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``chip`` that need a CUDA card and skip without one (decided in the
``card`` fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
