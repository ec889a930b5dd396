"""The port's test modules run torch on their test process's share of the
cores: the cores this process may use, divided among pytest-xdist's
workers (all of them without xdist), so that six workers on eight cores do
not each run eight OpenMP threads. A test module takes its share by
importing the fixture:

    from thread_budget import thread_budget  # noqa: F401

For the module's tests, torch's intra-op pool gets the share, and
OMP_NUM_THREADS and MKL_NUM_THREADS carry it to the subprocesses and
spawned ranks they start (`spawn_ranks` divides it among its ranks); all
three are restored after the module. Torch's inter-op pool is left as it
is: its size cannot change once torch has run an op.
"""

import os

import pytest
import torch

THREADS = max(1, len(os.sched_getaffinity(0))
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


@pytest.fixture(scope="module", autouse=True)
def thread_budget():
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", str(THREADS))
        mp.setenv("MKL_NUM_THREADS", str(THREADS))
        torch.set_num_threads(THREADS)
        try:
            yield THREADS
        finally:
            torch.set_num_threads(threads)
