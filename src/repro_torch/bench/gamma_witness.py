"""A second reading of Γ (training memory) on the card, to tell the
topology's own memory from what the process ran before it (the port's
own check; no counterpart in ``benchmarks/``).

Γ is ``max_memory_allocated`` over one training step
(``repro_torch.core.profiler``): every block the caching allocator hands
out during the step, cuDNN's backward workspaces included.  For a few
AlexNet points of the §6.1 sweep (random pruning, ``common.FULL``) this
script profiles Γ

* each in a fresh process, and again in one process right after the
  whole AlexNet grid of the sweep (19 levels x the geometry's batch
  sizes) has been profiled;
* with cuDNN on, the profiler's setting, and with cuDNN off
  (``torch.backends.cudnn.enabled = False``: PyTorch's own convolution
  backward, which takes no cuDNN workspace);

and beside Γ reads, over the same step, the allocator's peak of the bytes
that tensors requested (``torch.cuda.memory_stats``, before the
allocator rounds them up) and of the bytes it allocated.

    PYTHONPATH=src python -m repro_torch.bench.gamma_witness [--out FILE]

prints one JSON line per reading and writes them all to ``--out``
(default ``build/repro_torch/bench/gamma_witness.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from repro_torch.core.dataset import PAPER_ALL_LEVELS, GridSpec, _build_pruned, collect_grid
from repro_torch.core.profiler import profile_training
from repro_torch.device import resolve_device

from .common import BENCH_DIR, FULL

__all__ = ["POINTS", "measure", "main"]

# (level, batch size) of AlexNet where the sweep's Γ is not monotone in
# width: bs 256 at levels 0, 0.10, 0.30; bs 64 at levels 0.45, 0.50 (the
# sweep's own level values, so the topologies are the sweep's)
POINTS = tuple((PAPER_ALL_LEVELS[i], bs)
               for i, bs in ((0, 256), (2, 256), (6, 256), (9, 64), (10, 64)))
FAMILY = "alexnet"
OUT = str(BENCH_DIR / "gamma_witness.json")


def _grid(geometry=FULL) -> GridSpec:
    return GridSpec(FAMILY, PAPER_ALL_LEVELS, "random", tuple(geometry.batch_sizes),
                    geometry.width_mult, geometry.input_hw)


def measure(level: float, bs: int, geometry=FULL, device="cuda") -> dict:
    """Profile the sweep's AlexNet at ``level`` and ``bs`` once, with the
    geometry's steps: Γ, its parts and Φ as the profiler gives them, and
    on the card the allocator's peak requested and allocated MB over the
    memory step (``None`` on the CPU)."""
    dev = resolve_device(device)
    m = _build_pruned(_grid(geometry), level)
    res = profile_training(m, bs, device=dev, **geometry.profile_kw)
    row = {"family": FAMILY, "level": level, "bs": bs, "gamma_mb": res.gamma_mb,
           "temp_mb": res.temp_mb, "arg_mb": res.arg_mb, "phi_ms": res.phi_ms,
           "peak_requested_mb": None, "peak_allocated_mb": None}
    if dev.type == "cuda":
        # the profiler's memory step reset the peaks and was its last step
        # on the card (flops are counted on the meta device)
        stats = torch.cuda.memory_stats(dev)
        row["peak_requested_mb"] = stats["requested_bytes.all.peak"] / 1e6
        row["peak_allocated_mb"] = stats["allocated_bytes.all.peak"] / 1e6
    return row


def _readings(points, cudnn: bool, after_grid: bool, geometry, device) -> list[dict]:
    torch.backends.cudnn.enabled = cudnn
    if after_grid:
        collect_grid(_grid(geometry), None, device=device, **geometry.profile_kw)
    return [dict(measure(lv, bs, geometry, device), cudnn=cudnn,
                 process="after the grid" if after_grid else "fresh")
            for lv, bs in points]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda")
    # one child process's share of the readings (started by the run without them)
    ap.add_argument("--point", type=int, default=None, help="index into POINTS")
    ap.add_argument("--after-grid", action="store_true")
    ap.add_argument("--no-cudnn", action="store_true")
    args = ap.parse_args(argv)

    if args.point is not None or args.after_grid:
        points = POINTS if args.point is None else [POINTS[args.point]]
        rows = _readings(points, not args.no_cudnn, args.after_grid, FULL, args.device)
        for r in rows:
            print(json.dumps(r), flush=True)
        return rows

    rows = []
    for cudnn in (["--no-cudnn"], []):
        runs = [["--point", str(i)] for i in range(len(POINTS))] + [["--after-grid"]]
        for extra in runs:
            cmd = [sys.executable, "-m", "repro_torch.bench.gamma_witness",
                   "--device", args.device, *cudnn, *extra]
            out = subprocess.run(cmd, check=True, stdout=subprocess.PIPE,
                                 text=True).stdout
            for line in out.splitlines():
                if line.startswith("{"):
                    rows.append(json.loads(line))
                    print(line, flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
