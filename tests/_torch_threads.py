"""A fixture for the port's CPU tests: torch on one thread.

The suite runs in several pytest-xdist workers at once, about one per
core, and torch's intra-op thread pool in each worker oversubscribes the
cores: a frame of small tensor operations then runs some 25 times slower
than on one thread (the oracle's finite-difference test: 146 s on 8
threads against 5.8 s on 1, with six other processes busy). A module
takes it with ``pytestmark = pytest.mark.usefixtures("one_torch_thread")``
after importing it.
"""

import pytest
import torch


@pytest.fixture(scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
