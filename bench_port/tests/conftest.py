"""The benchmark's tests. Tests that need a CUDA card carry the ``card``
marker and take the ``card`` fixture, which skips them where there is
none; the look happens inside the fixture, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
