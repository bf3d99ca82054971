"""Fixture of the port's tests that need the card (marked ``cuda``).

The decision is made inside the fixture, when a test runs, so every
worker collects the same tests.
"""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)
