"""The reduction of a ``torch.profiler`` trace of the window's traced steps
to what the per-layer readers read.

* ``window_s``: the traced steps' wall time on the host clock, from a
  ``synchronize`` before the first to one after the last.
* ``busy_s``: the union of the intervals in which an operation (kernel,
  copy, fill) ran on the device.
* ``kernel_s``: device seconds by operation name.
* ``under(op)``: device seconds of the operations launched inside the
  host operator ``op`` (its outermost calls), through the profiler's
  link of each device operation to the operator that launched it,
  without the operations that the profiler hangs on CUPTI's overhead
  events (``OVERHEAD``), which belong to another operator.
* ``gaps``: the longest idle intervals between device operations, each
  named by the innermost host operator running at its middle.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["OVERHEAD", "TraceSummary", "summarize"]

# CUPTI's overhead activities, which the profiler puts among the host's
# events.  Such an event can carry the kernels of an unrelated operator
# (its correlation id is drawn from another sequence than the operators'),
# so counting them counts those kernels twice.
OVERHEAD = frozenset({"Driver Compiler", "Buffer Flush", "Instrumentation", "Resource",
                      "Runtime Triggered Module Loading", "Lazy Function Loading",
                      "Command Buffer Full", "Activity Buffer Request", "UVM Activity Init"})


@dataclass
class TraceSummary:
    steps: int
    window_s: float
    busy_s: float
    kernel_s: dict[str, float]
    gaps: list[tuple[str, float]]
    _under: dict[str, float] = field(default_factory=dict)

    def under(self, op: str) -> float | None:
        """Device seconds under the host operator ``op``, or None if the
        trace holds no such operator."""
        return self._under.get(op)

    @property
    def device_s(self) -> float:
        return sum(self.kernel_s.values())

    def breakdown(self, top: int = 10, width: int = 160) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:width], v] for k, v in ops],
                "idle_gaps": [[k[:width], v] for k, v in self.gaps[:top]]}


def _is_device(e) -> bool:
    return e.device_type.name != "CPU"


def _under_ops(cpu_events) -> dict[str, float]:
    """Device seconds under each host operator name, counting an operator
    only where no ancestor has its name, and nothing under an overhead
    event."""
    total: dict[int, float] = {}

    def dev(e) -> float:
        key = id(e)
        if key not in total:
            total[key] = 0.0 if e.name in OVERHEAD else (
                sum(k.duration for k in e.kernels) * 1e-6 + sum(dev(c) for c in e.cpu_children))
        return total[key]

    out: dict[str, float] = defaultdict(float)
    stack = [(e, frozenset()) for e in cpu_events if e.cpu_parent is None]
    while stack:
        e, above = stack.pop()
        if e.name not in above:
            out[e.name] += dev(e)
        names = above | {e.name}
        stack.extend((c, names) for c in e.cpu_children)
    return dict(out)


def summarize(events, steps: int, window_s: float, n_gaps: int = 10) -> TraceSummary:
    """``events``: the profiler's ``events()`` over the traced steps."""
    device = [e for e in events if _is_device(e)]
    cpu = [e for e in events if not _is_device(e)]
    kernel_s: dict[str, float] = defaultdict(float)
    spans = []
    for e in device:
        kernel_s[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, gaps = 0.0, []
    if spans:
        lo, hi = spans[0]
        for s, t in spans[1:]:
            if s > hi:
                busy += hi - lo
                gaps.append((s - hi, hi, s))
                lo, hi = s, t
            else:
                hi = max(hi, t)
        busy += hi - lo
    gaps.sort(reverse=True)
    named = []
    for length, s, t in gaps[:n_gaps]:
        mid = (s + t) / 2
        host = [e for e in cpu if e.time_range.start <= mid < e.time_range.end]
        name = min(host, key=lambda e: e.time_range.end - e.time_range.start).name \
            if host else "no host operator"
        named.append((name, length * 1e-6))
    return TraceSummary(steps, window_s, busy * 1e-6, dict(kernel_s), named, _under_ops(cpu))
