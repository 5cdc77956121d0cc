"""torch's intra-op threads in the port's CPU test files.

The tier-1 command runs the tests in six xdist workers on one host, and
torch takes as many intra-op threads as the host has CPUs in each of them,
so the workers' torch threads oversubscribe the CPUs.  A test file of the
port imports `torch_threads` (an autouse fixture) to run its tests at
THREADS threads, restored after the file.  Measured on an 8-CPU host with
the tier-1 command's workers over six of the port's longest files:
tests/test_torch_video_checkpoint.py took 251 s as it was and 39 s at 2
threads (the six files 272 s and 90 s of wall clock).
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """torch at THREADS intra-op threads for the importing file's tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)
