"""The benchmark's tests: on the CPU at tiny sizes; those that need the card
carry the ``cuda`` marker and skip without one (decided in a fixture)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
