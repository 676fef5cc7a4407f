"""One torch CPU thread for a test file's tests.

Tier-1 runs six pytest-xdist workers on the machine's eight cores, and
torch runs a CPU op on as many threads as there are cores: an op then
waits on threads whose cores another worker holds. Under that load the
port's test files took 5-20 times their time alone (the rate and GRU
probes' script runs: 74 s with six cores busy, 12 s on one thread).
A test file that imports :func:`one_torch_thread` runs its tests on one
torch thread and gives the worker its thread count back after them: the
same ops on the same inputs, each sum in one thread's order.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
