"""One intra-op thread for the port's side of the CPU tests.

The port's CPU work in these tests is many small ops.  Under a test run's
parallel workers, each worker's default pool of one thread a core
oversubscribes the host, and spinning threads slowed such tests fifty- to
a hundredfold.  A test module takes the pool down to one thread by
importing :func:`one_torch_thread`; the caller's count comes back after
the module.  A script a test runs in a fresh interpreter gets
``OMP_NUM_THREADS=1`` in its environment instead.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
