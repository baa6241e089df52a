"""One intra-op thread for the port's tests on the CPU.

The suite runs in several worker processes at once.  With PyTorch's
default of one OpenMP thread per core the workers oversubscribe the cores,
and the port's many small operations wait on threads that spin for the
cores: with every core busy, one step of the four estimators on the CPU
took 17.8 s with 8 threads and 1.3 s with one.  Each ``test_torch_*.py``
file imports ``one_torch_thread``; it applies to the file's tests and
restores the previous count after them.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
