"""The program's spans (``repro_torch.core.spans``: ``repro.step`` and its
phases, ``repro.conv_mm``, ``repro.conv_backward``, ``repro.bn``) as the
benchmark reads them.

* ``program_host_s(name)``: the host durations the program kept for the
  span ``name`` while the profiler collected, or ``[]`` from a program
  that keeps none;
* ``idle_by_span(events)``: every idle interval between the device's
  operations in a ``torch.profiler`` trace, each given to the innermost
  ``repro.*`` span open on any host thread at its middle, or to
  ``"outside the program"``;
* ``waited_share(events, name)``: the share of the named spans inside
  which a launch waited for room in the device's queue.

Run as a script, one traced look at a cell on the card, for what the
result line does not hold:

    python3 perfbench/spans.py --workload <name> --seed <n> [--out FILE]

sets the cell up as a run does, runs an untraced window of the traffic's
``trace_steps`` steps and then a traced one of as many, and prints one
JSON line: both windows' ms a step, the caching
allocator's device allocations, frees and retries over each window, the
idle split by span, the device time under each span (as
``tracing.TraceSummary.under`` counts it and without the overhead events'
kernels) beside the per-layer readers' kernel-name and operator sums,
each span's host time and waited share, and the cell's per-layer metrics.
It checks no output: ``run.py`` does.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
if __name__ == "__main__":
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)
    sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]

__all__ = ["PREFIX", "OUTSIDE", "WAIT", "program_host_s", "idle_by_span", "waited_share",
           "main"]

PREFIX = "repro."
OUTSIDE = "outside the program"
# a launch that waited for room in the queue (one of tracing.OVERHEAD)
WAIT = "Command Buffer Full"


def program_host_s(name: str) -> list[float]:
    import importlib

    try:
        spans = importlib.import_module("repro_torch.core.spans")
    except ImportError:
        return []
    return spans.host_seconds().get(name, [])


def _device_gaps(events) -> list[tuple[float, float]]:
    """(start, end) in µs of every interval between the device's
    operations in which none ran (a user annotation that the profiler
    mirrors onto the device's timeline is no operation)."""
    ops = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type.name != "CPU" and not getattr(e, "is_user_annotation", False))
    gaps = []
    if ops:
        hi = ops[0][1]
        for s, t in ops[1:]:
            if s > hi:
                gaps.append((hi, s))
            hi = max(hi, t)
    return gaps


def idle_by_span(events) -> dict[str, float]:
    """Idle seconds between the device's operations by the innermost
    ``repro.*`` span open at each interval's middle, largest first."""
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type.name == "CPU" and e.name.startswith(PREFIX)
             and e.time_range.end > e.time_range.start]
    gaps = _device_gaps(events)
    # a sweep over the spans' ends (0), starts (1) and the gaps' middles (2):
    # a span holds a middle m when start <= m < end
    points = [(s, 1, i) for i, (s, _, _) in enumerate(spans)]
    points += [(t, 0, i) for i, (_, t, _) in enumerate(spans)]
    points += [((s + t) / 2, 2, i) for i, (s, t) in enumerate(gaps)]
    points.sort()
    open_: dict[int, tuple] = {}
    out: dict[str, float] = defaultdict(float)
    for _, kind, i in points:
        if kind == 0:
            del open_[i]
        elif kind == 1:
            open_[i] = spans[i]
        else:
            s, t = gaps[i]
            name = min(open_.values(), key=lambda sp: sp[1] - sp[0])[2] if open_ else OUTSIDE
            out[name] += (t - s) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _host(events):
    return [e for e in events if e.device_type.name == "CPU"]


def waited_share(events, name) -> float | None:
    """Share of the ``name`` events holding a ``WAIT`` event."""
    def waited(e) -> bool:
        return any(c.name == WAIT or waited(c) for c in e.cpu_children)

    found = [e for e in _host(events) if e.name == name]
    return sum(map(waited, found)) / len(found) if found else None


def _allocator(dev) -> dict[str, int]:
    import torch

    stats = torch.cuda.memory_stats(dev)
    return {k: int(stats.get(k, 0)) for k in
            ("num_device_alloc", "num_device_free", "num_alloc_retries")}


def _counted(window_fn, dev):
    before = _allocator(dev)
    window = window_fn()
    after = _allocator(dev)
    return window, {k: after[k] - before[k] for k in after}


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import spec, tracing
    from perfbench.run import LayerContext, _peaks
    from perfbench.window import run_window

    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available():
        print("refused: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    entry = spec.load_module(cell.root / "entries" / f"{cell.traffic['entry']}.py").Entry(
        cell, args.seed, dev)
    entry.setup()
    steps = int(cell.traffic["trace_steps"])
    plain, alloc_plain = _counted(lambda: run_window(entry, dev, steps=steps), dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced, alloc_traced = _counted(lambda: run_window(entry, dev, steps=steps), dev)
    events = prof.events()
    summary = tracing.summarize(events, traced.steps, traced.seconds)
    idle = idle_by_span(events)
    names = ("repro.step", "repro.step.forward", "repro.step.backward", "repro.step.update",
             "repro.conv_mm", "repro.conv_backward", "repro.bn")
    waited = {n: waited_share(events, n) for n in ("repro.step", "repro.conv_mm", "repro.bn")}
    n_wait = sum(1 for e in _host(events) if e.name == WAIT)
    del events, prof
    costs = entry.costs()
    entry.release()

    per_step = 1e3 / steps
    kind = torch.cuda.get_device_name(dev)
    ctx = LayerContext(summary, costs, *_peaks(kind, cell.config["dtype"], cell.root), cell.root)
    metrics = {m["name"]: spec.reader("metrics", m["name"], cell.root).read(ctx)
               for m in cell.per_layer}
    conv = spec.reader("metrics", "conv_mm.roofline_pct", cell.root).device_s(summary)
    bwd = spec.reader("metrics", "conv_bwd.roofline_pct", cell.root).device_s(summary)
    host = {}
    for name in names:
        ts = sorted(program_host_s(name))
        if ts:
            host[name] = {"n": len(ts), "mean_ms": 1e3 * sum(ts) / len(ts),
                          **{f"p{q}_ms": 1e3 * ts[len(ts) * q // 100] for q in (10, 50, 90)},
                          "sum_ms_per_step": sum(ts) * per_step}
    result = {
        "workload": cell.name, "seed": args.seed, "steps": steps, "device": kind,
        "window_ms_per_step": {"plain": plain.seconds * per_step, "traced": traced.seconds * per_step},
        "idle_pct": 100.0 * (1.0 - summary.busy_s / summary.window_s),
        "idle_ms_per_step": (summary.window_s - summary.busy_s) * per_step,
        "idle_by_span_ms_per_step": {k: v * per_step for k, v in idle.items()},
        "device_ms_per_step": {
            "all": summary.device_s * per_step,
            **{n: (summary.under(n) or 0.0) * per_step for n in names},
            "kernels named conv_mm_*": conv * per_step,
            "aten::convolution_backward": bwd * per_step},
        "host": host,
        "waited_share": waited,
        "waits_per_step": n_wait / steps,
        "allocator": {"plain": alloc_plain, "traced": alloc_traced},
        "metrics": metrics,
    }
    line = json.dumps(result)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
