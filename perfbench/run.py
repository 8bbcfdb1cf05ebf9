"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one run of
one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--workload`` names a cell of ``BENCHMARK.json``; its configuration,
traffic, step kind, limits and metric readers are files found by name
(``spec.py``).  A run draws its inputs from ``--seed`` on the device, sets
up the program's step and warms it up (``setup_s``), runs the closed-loop
window (``window.py``), frees the program's state, runs the reference and
compares (``compare.py``), and prints one JSON line as the last line of
standard output:

* ``--trace 0``: the cell's end-to-end metrics, measured for ``--seconds``;
* ``--trace 1``: its per-layer metrics, read from a ``torch.profiler``
  trace of ``trace_steps`` steps (``tracing.py``), with the device's busy
  and window seconds and a breakdown.

The last lines of standard error, and the result's last key ``checks``,
give each compared number beside its limit.  The run exits 2 without a
result when no card is there (or fewer than the cell asks for), and 3
when a module of JAX or of the JAX package was loaded (``imports.py``).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if __name__ == "__main__":
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)                 # no module here shadows a library's
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

__all__ = ["LayerContext", "run", "main"]


@dataclass
class LayerContext:
    """What a per-layer reader reads: the trace summary, the step's
    arithmetic, the chip's peaks for the configuration's type."""
    trace: object
    costs: object
    peak_flops: float | None
    peak_bytes: float | None
    root: Path


def _peaks(kind: str, dtype: str, root: Path):
    table = json.loads((root / "peaks.json").read_text())
    row = table.get(kind)
    if row is None or dtype not in row["flops"]:
        return None, None
    return float(row["flops"][dtype]), float(row["bytes_per_s"])


def _card(err) -> None:
    """The card's name and power limit, beside every number of the run."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        line = "unknown (nvidia-smi unavailable)"
    print(f"card: {line}", file=err)


def run(cell, seed: int, seconds: float, trace: bool, device="cuda", *,
        t0: float = T0, program=None, out=None, err=None) -> int:
    """One run of ``cell`` (a ``spec.Cell``) on ``device``; prints the
    result line and returns the exit code.  ``program`` replaces the
    program's step (the control, the tests' faults)."""
    import torch

    from perfbench import compare, imports, spec, tracing
    from perfbench.window import run_window

    out = out or sys.stdout
    err = err or sys.stderr
    dev = torch.device(device)
    tr = cell.traffic
    t_imports = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
    t_device = time.perf_counter()
    entry = spec.load_module(cell.root / "entries" / f"{tr['entry']}.py").Entry(
        cell, seed, dev, program)
    entry.setup()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            window = run_window(entry, dev, steps=int(tr["trace_steps"]), t0=t0)
        summary = tracing.summarize(prof.events(), window.steps, window.seconds)
        del prof
    else:
        window = run_window(entry, dev, seconds=seconds, t0=t0)
    failed = entry.failed()
    entry.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        kind = torch.cuda.get_device_name(dev)
        device_info = {"platform": "gpu", "kind": kind, "count": cell.chips,
                       "memory_peak_bytes": window.peak_bytes}
    else:
        kind = "cpu"
        device_info = {"platform": "cpu", "kind": kind, "count": 1, "memory_peak_bytes": 0}

    t_check = time.perf_counter()
    readings = entry.readings()
    check_s = time.perf_counter() - t_check
    ok, checks = compare.verdict(readings, cell.limits)

    metrics, result_extra = {}, {}
    if trace:
        peak_flops, peak_bytes = _peaks(kind, cell.config["dtype"], cell.root)
        ctx = LayerContext(summary, entry.costs(), peak_flops, peak_bytes, cell.root)
        for m in cell.per_layer:
            v = spec.reader("metrics", m["name"], cell.root).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result_extra["breakdown"] = summary.breakdown()
    else:
        for m in cell.end_to_end:
            v = spec.reader("e2e", m["name"], cell.root).read(window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    if dev.type == "cuda":
        _card(err)
    print(f"workload {cell.name} seed {seed} trace {int(trace)}: {window.steps} steps "
          f"in {window.seconds:.3f} s; step_ms samples {len(window.step_ms)}; "
          f"setup {window.setup_s:.3f} s (imports {t_imports - t0:.3f}, device "
          f"{t_device - t_imports:.3f}, program and warm-up "
          f"{window.setup_s - (t_device - t0):.3f}); check {check_s:.3f} s", file=err)
    for name, v in readings.items():
        if name not in cell.limits:
            print(f"reading {name} {v!r} (not compared)", file=err)
    for name, m in metrics.items():
        print(f"metric {name} {m['value']!r} {m['unit']}", file=err)

    found = imports.forbidden()
    if found:
        print(f"refused: the run loaded {', '.join(found)}", file=err)
        err.flush()
        return 3
    result = {"correct": bool(ok and failed == 0), "attempted": window.steps,
              "failed": failed, "metrics": metrics, "device": device_info,
              **result_extra, "checks": checks}
    print(f"failed {failed} of {window.steps} steps", file=err)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import spec

    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"refused: {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return run(cell, args.seed, args.seconds, bool(args.trace), "cuda")


if __name__ == "__main__":
    sys.exit(main())
