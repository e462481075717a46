"""One torch thread a test process, for the port's CPU test files.

The suite runs under pytest-xdist with 6 workers on an 8-core machine, and
by default each worker's torch runs every op on a pool of 8 OpenMP threads
(besides XLA's own pool): 48 spinning threads on 8 cores, so CPU-heavy
cases ran many times slower in the whole run than alone. Each
``tests/test_torch_*.py`` file that computes on the CPU imports
``one_torch_thread``, an autouse fixture that runs the file's tests (its
module fixtures included) on one intra-op thread and gives the worker its
previous count back after the file. Every comparison keeps its tolerance.
Subprocesses the tests start get ``one_thread_env()``."""

import os

import pytest
import torch


def one_thread_env() -> dict:
    """``os.environ`` with torch's thread count at one, for a subprocess."""
    return {**os.environ, "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's tests on one intra-op thread; the worker's count after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
