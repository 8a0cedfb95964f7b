"""A fixture for the port's heavier CPU test files: torch at two threads
per test, the previous count restored after it.

The suite runs several pytest workers on the machine's cores, and torch
takes one thread per core in each of them: the workers' thread pools
then oversubscribe the cores, and the small ops of a CPU train step wait
on each other (measured under three workers: 75 s for a test that takes
27 s at two threads and 12 s alone).
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
