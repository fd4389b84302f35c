"""One torch intra-op thread for the tests of a module that imports
``one_torch_thread``.

The suite runs in several pytest-xdist workers on one host, and each
worker's torch starts an intra-op pool as large as the host's cores: with
six workers the pools oversubscribe the cores several times over, and the
port's small CPU ops spend most of their time in the pools' spin-waits.
One thread a worker computes the same ops; a module's comparisons between
its own runs stay in one setting, and its comparisons with the JAX package
keep their tolerances. The count is restored when the module ends.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
