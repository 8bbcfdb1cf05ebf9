"""How the port's test files share the host with the JAX package's tests.

Under a parallel run (``pytest -n``) the port's files run beside the JAX
package's, and their heavy cases (XLA compiling the JAX reference's
float64 and f32 CNN gradients and steps, Pallas kernels in interpret
mode, the PyTorch side) keep several cores busy for minutes.  The JAX
package's wall-clock test
``tests/test_predictor.py::test_end_to_end_profile_fit_predict`` profiles a
grid of millisecond training steps and then one held-out point, and fails
when the load on the host changes between the two: a step of a few
milliseconds doubles when its threads wait behind another process's.

``port_host_share``, imported by each port test file that computes as an
autouse fixture, runs every thread of the file's process under
``SCHED_IDLE``: the kernel gives such threads a core only when no
ordinary thread wants it, and an ordinary thread that wakes preempts them
at once.  The port's files then take only what the JAX package's tests
leave idle, and the reference's timings see the host as if the port were
not there.  PyTorch keeps one intra-op thread, so its f32 sums keep the
order the port's tolerances were set with.  The policy is restored when
the file ends (the next file in the worker may be the JAX package's); a
process that could not restore it (no privilege to raise its priority
again) keeps its policy throughout.

``float64_jit`` lowers the largest cost of those files: the float64
"exact" references of the CNN gradient and step tests are compiled with
LLVM's optimisation off, which takes about half the compile time and
moves a float64 result in its last bits only.  The f32 references, whose
own error sets the tolerances, compile as before.
"""

import os
import resource

import jax
import pytest
import torch


def _threads() -> list[int]:
    try:
        return [int(tid) for tid in os.listdir("/proc/self/task")]
    except OSError:
        return []


def _set_policy(policy: int) -> None:
    """``policy`` for every thread of this process (new threads inherit it
    from the thread that starts them)."""
    for tid in _threads():
        try:
            os.sched_setscheduler(tid, policy, os.sched_param(0))
        except ProcessLookupError:    # the thread ended meanwhile
            pass


def _can_restore() -> bool:
    """Whether this process may leave SCHED_IDLE again: root, or an
    RLIMIT_NICE that permits nice 0."""
    return os.geteuid() == 0 or resource.getrlimit(resource.RLIMIT_NICE)[0] >= 20


def float64_jit(fn):
    """``jax.jit(fn)`` for a float64 reference: compiled per call at XLA's
    backend optimisation level 0."""
    jitted = jax.jit(fn)

    def call(*args):
        return jitted.lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})(*args)

    return call


@pytest.fixture(autouse=True, scope="module")
def port_host_share():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    idle = (hasattr(os, "SCHED_IDLE") and _can_restore()
            and os.sched_getscheduler(0) == os.SCHED_OTHER)
    if idle:
        _set_policy(os.SCHED_IDLE)
    yield
    if idle:
        _set_policy(os.SCHED_OTHER)
    torch.set_num_threads(n)
