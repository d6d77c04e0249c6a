"""Shared fixtures of the benchmark's CPU tests; ``card`` skips a test
unless an NVIDIA card is present, decided when the test runs."""

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")
