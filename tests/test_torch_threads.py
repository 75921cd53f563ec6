"""One torch thread per test process for the port's CPU tests.

The tests run thousands of small tensor ops, for which torch's thread
pool costs more than it gains, and the suite runs in several worker
processes at once: a pool of one thread per core in every worker
oversubscribes the machine (measured: the ``tests/test_torch_*`` files
under four workers took about a third of the time with one thread).  A
test module opts in by importing the fixture; this module checks it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_torch_thread_inside_a_module_that_imports_it():
    assert torch.get_num_threads() == 1
