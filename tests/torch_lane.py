"""The port's test files share one worker setting: one thread per native
thread pool while a module of theirs runs.

The tier-1 lane runs six test processes on the host's cores.  Each
process otherwise keeps a thread per core in numpy's OpenBLAS pool and in
torch's OpenMP pool, whose waiting threads spin, so the six processes'
pools take the cores from each other's work: on an 8-core host the
port's test files, six workers with --dist loadfile, took 3,020
worker-seconds with the default pools and 1,735 with this fixture.
A module imports the fixture (`from torch_lane import
one_thread_per_pool  # noqa: F401`); it sets the limits for the module's
tests and restores them after, so the JAX package's test files on the
same worker keep their own settings.  The tolerances of the parity tests
hold either way.
"""

import pytest
import threadpoolctl
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread_per_pool():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpoolctl.threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(n)
