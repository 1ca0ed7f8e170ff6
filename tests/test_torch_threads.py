"""One intra-op torch thread for the port's CPU tests.

The tier-1 suite runs in several pytest-xdist workers that share the cores.
There torch's intra-op thread pool, sized to every core in each worker,
slows the tests' many small ops several times over (the port's files took
190 s under six workers with the default pool and 91 s with one thread).
A port test module imports ``one_intra_op_thread``; being autouse, it then
runs each of the module's tests on one thread and restores the count after.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_intra_op_thread_is_set_for_the_test():
    assert torch.get_num_threads() == 1
