"""An autouse fixture for test modules of the port whose tensors are tiny:
each test runs torch's CPU ops on one thread, and gets the process's thread
count back after it.  The test run puts several pytest processes on the
machine's cores, and a pool of threads per process then only contends for
them.  A test compares with a tolerance, or two results computed under
the same setting."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
