"""One intra-op thread for torch in the port's CPU test modules.

The suite runs in several pytest-xdist workers at once.  Left alone,
torch in each worker starts a thread a core, and the oversubscribed cores
slow both the port's tests and the wall-clock checks of the tests that
share the machine (tests/test_native.py::test_native_throughput).  A test
module that imports `one_torch_thread` runs with one thread and restores
the old count when it ends.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
