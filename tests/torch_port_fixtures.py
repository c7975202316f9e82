"""Shared fixtures for the PyTorch port's CPU parity tests.

Import the fixture into a test module to apply it there (autouse).
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def single_torch_thread():
    # With JAX in the same process, torch's multi-threaded CPU kernels have
    # returned wrong values for one thread's share of the elements on a
    # first call (torch.sqrt off by ~2**-12 relative); one thread is exact.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread_module():
    # For a module whose shared fixtures build pipelines: a worker thread
    # keeps the torch thread count in force when it first ran an op, so
    # the count is set before the module-scoped fixtures start any.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
