"""The measured window: a closed loop over the entry's calls.

Each call is issued as soon as the previous one returns, with no
synchronisation between calls.  On the card a CUDA event is recorded on
the current stream at every step boundary, so a step's time is the time
between two consecutive boundaries on the device, waits for the host
included; the window ends with ``torch.cuda.synchronize()``.  The peak of
allocated device memory is taken over the window, after
``reset_peak_memory_stats`` at its start.  On the CPU (the tests) the
boundaries are host-clock readings.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

__all__ = ["Window", "run_window"]


@dataclass
class Window:
    steps: int
    items: int
    seconds: float
    step_ms: list[float]
    peak_bytes: int
    setup_s: float = 0.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mark(dev: torch.device):
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


def run_window(entry, dev: torch.device, *, seconds: float | None = None,
               steps: int | None = None, t0: float = 0.0) -> Window:
    """Calls ``entry.call(i)`` for ``seconds`` of host clock (at least once),
    or ``steps`` times; ``t0`` is the process's start on the same clock, so
    that ``setup_s`` runs to the first timed call."""
    if (seconds is None) == (steps is None):
        raise ValueError("give seconds or steps")
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    start = time.perf_counter()
    end = start + (seconds or 0.0)
    marks = [_mark(dev)]
    i = 0
    while True:
        out = entry.call(i)
        marks.append(_mark(dev))
        entry.keep(i, out)
        i += 1
        if (i >= steps) if steps is not None else (time.perf_counter() >= end):
            break
    _sync(dev)
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    step_ms = [_ms(a, b) for a, b in zip(marks, marks[1:])]
    return Window(i, i * entry.items_per_step, wall, step_ms, int(peak), start - t0)
