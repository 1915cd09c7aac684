"""One torch intra-op thread for the PyTorch port's CPU tests.

The suite runs in several worker processes at once (pytest-xdist), and
torch's OpenMP pool spins while it waits for work: two or three processes
that each run large torch ops on every core slow each other down by 10x and
more (on an 8-core host, the three deck-comparison files side by side took
over 900 s with torch's default threads and 47 s with one).  A test module
that imports `one_torch_thread` runs each of its tests with one thread and
restores the count afterwards.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
