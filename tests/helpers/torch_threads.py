"""One intra-op thread for the port's CPU tests.

The tier-1 suite runs as several xdist workers on one host's cores.
PyTorch's CPU kernels start one intra-op thread per core in every worker,
and on the small tensors of these tests the workers' threads then spin
against each other: on an 8-core host, a gradient check that takes 13 s
with one thread did not finish in 600 s in each of 6 concurrent processes
with 8 threads. A test module imports :func:`one_torch_thread` (an
autouse fixture) to run its tests on one thread, restoring the count
after the module."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
