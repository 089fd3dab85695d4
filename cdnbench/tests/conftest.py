"""The benchmark's own tests: ``python -m pytest cdnbench/tests``. They
import no JAX. Tests that need a CUDA card are marked ``cuda`` and decide
inside a fixture whether there is one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.cuda.get_device_name(0)
