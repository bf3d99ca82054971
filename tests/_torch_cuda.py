"""Fixtures shared by the port's tests.

``cuda_device``: the tests that need the card (marked ``cuda``) take it.
The decision is made inside the fixture, when a test runs, so every
worker collects the same tests.

``one_intra_op_thread``: a port test module imports it (module scope,
autouse). The suite runs several workers on the host's cores, and smoke
sizes gain nothing from threads: one intra-op thread in the module, and
``OMP_NUM_THREADS=1`` for every process the module starts.
"""
import os

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module, and ``OMP_NUM_THREADS=1`` in
    the environment its subprocesses inherit; both restored after."""
    n, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = omp
