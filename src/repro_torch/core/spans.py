"""Named host ranges (spans) at the layer boundaries of the CNN step.

``span(name)`` opens a named host range while a ``torch.profiler``
session collects, so that the range lands in the trace on the same clock
as the device's operations, and every idle interval of the device can be
matched with the span that was open on the host.  While no session
collects it returns one shared ``nullcontext``: the check is a single
attribute read (0.7 µs a span on an Intel Xeon host, where building a
``record_function`` costs about 9 µs even with no profiler running).
Spans follow the profiler; nothing else turns them on.

The range is ``torch._C._profiler._RecordFunctionFast`` (a host operator
range: 1.4 µs with a CPU-only profiler on the same host, against 14 µs
for ``record_function``), not ``record_function``: the latter is a user
annotation, which Kineto mirrors onto the device's timeline as an event
of its own, so that a trace's device operations would count each span's
extent as device work.

While a session collects, each span also keeps its host duration, by
name, for the whole process (as the profiler's session is process-wide):
:func:`host_seconds` reads them and :func:`clear` drops them.

The spans of the CNN step:

* ``repro.step``: one call of ``core.profiler.make_train_step``'s step or
  of ``make_infer_fn``'s forward, with ``repro.step.forward``,
  ``repro.step.backward`` and ``repro.step.update`` inside a training step;
* ``repro.conv_mm``: ``kernels.conv_mm.ops.conv_mm``, the wrapper's checks,
  tile rule, allocation and launch;
* ``repro.conv_backward``: ``kernels.conv_mm.ops.conv_backward``, on the
  thread that runs autograd's backward;
* ``repro.dw_conv``: ``kernels.conv_mm.ops.depthwise_conv``, a depthwise
  convolution's forward;
* ``repro.dw_conv.backward``: its backward, on autograd's thread, with the
  ``repro.conv_backward`` of its gradients inside;
* ``repro.bn``: the BatchNorm forward of ``models.cnn.C``.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.autograd.profiler as _profiler

__all__ = ["span", "host_seconds", "clear"]

_OFF = contextlib.nullcontext()
_host: dict[str, list[float]] = {}


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        _host.setdefault(self.name, []).append(dt)
        return False


def span(name: str):
    """A context manager: the named range while a profiler collects,
    nothing otherwise."""
    return _Span(name) if _profiler._is_profiler_enabled else _OFF


def host_seconds() -> dict[str, list[float]]:
    """Host seconds of each span closed while a profiler collected, by
    name, in the order they closed, since the process started or
    :func:`clear` was last called."""
    return {name: list(ts) for name, ts in _host.items()}


def clear() -> None:
    _host.clear()
