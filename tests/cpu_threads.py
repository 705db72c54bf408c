"""A fixture for the port's tests of tiny models: one intra-op thread.

The tiny models gain nothing from torch's intra-op threads, and under
``pytest -n 6`` six workers share the host's cores: each of their
OpenMP teams then waits on cores the others hold, and a test that takes
seconds alone takes minutes. A module that imports ``one_thread`` runs
its tests with one thread and restores the count after.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
