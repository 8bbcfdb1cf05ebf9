"""How the port's test files share the host with the JAX package's tests.

Under a parallel run (``pytest -n``) the port's files run beside the JAX
package's, and their heavy cases (the JAX reference's float64 CNN
gradients, Pallas kernels in interpret mode, the PyTorch side) spread over
every core.  The JAX package's wall-clock test
``tests/test_predictor.py::test_end_to_end_profile_fit_predict`` profiles a
grid and then one held-out point, and fails when the load on the host
changes between the two.  ``port_host_share``, imported by each port test
file as an autouse fixture, keeps the file's threads (JAX's and PyTorch's)
on the lowest quarter of the host's cores and PyTorch to one intra-op
thread, so the rest sees only the JAX package's own load.  JAX's CPU
backend is started before the threads are pinned: XLA sizes its thread
pool, and with it the order of its f32 sums, by the cores it sees then.
"""

import os

import jax
import pytest
import torch


def _pin_threads(cores) -> None:
    """Every thread of this process onto ``cores``."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cores)
        except OSError:          # the thread ended meanwhile
            pass


@pytest.fixture(autouse=True, scope="module")
def port_host_share():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cores = (sorted(os.sched_getaffinity(0))
             if hasattr(os, "sched_setaffinity") and os.path.isdir("/proc/self/task")
             else [])
    if cores:
        jax.devices()            # the backend and its thread pool, on every core
        _pin_threads(cores[: max(1, len(cores) // 4)])
    yield
    if cores:
        _pin_threads(cores)
    torch.set_num_threads(n)
