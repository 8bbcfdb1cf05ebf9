"""The readings that a cell's limits are set from, on the card at the
cell's own size: the program on many seeds (the lower readings), the
control (the reference computed in TF32, put in the program's place) and
the faults of ``faults.py`` (the upper readings).  The benchmark's own
runs never run this.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \\
        --what program,control,half_batch,altered,unchanged [--out FILE]

Each (what, seed) sets up the cell as a run does, runs a short window
(training: none, its checked steps are set-up's first steps; inference:
``--steps`` calls, from which the run's sample is compared), and prints
one JSON line of readings.  The last line sums them up: for each number,
the largest reading of the program and the smallest of each other kind.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if __name__ == "__main__":
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)
    sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]

__all__ = ["readings", "main"]


def readings(cell, seed: int, what: str, device, steps: int) -> dict[str, float]:
    """The compared numbers of one set-up of ``cell`` with ``what`` in the
    program's place (``program``: the program itself)."""
    import torch

    from perfbench import faults, spec
    from perfbench.window import run_window

    program = {"program": None, "control": faults.reference_program("tf32"),
               **faults.FAULTS}[what]
    dev = torch.device(device)
    entry = spec.load_module(cell.root / "entries" / f"{cell.traffic['entry']}.py").Entry(
        cell, seed, dev, program)
    entry.setup()
    if "keep_every" in cell.traffic:     # it compares a sample of the window's outputs
        run_window(entry, dev, steps=steps)
    entry.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = entry.readings()
    del entry
    gc.collect()
    return out


def summary(rows: list[dict]) -> dict:
    out: dict = {}
    for r in rows:
        for name, v in r["readings"].items():
            key = "lower" if r["what"] == "program" else r["what"]
            pick = max if key == "lower" else min
            slot = out.setdefault(name, {})
            slot[key] = pick(slot[key], v) if key in slot else v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--what", default="program,control,half_batch,altered,unchanged")
    ap.add_argument("--steps", type=int, default=64, help="inference window calls")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)

    from perfbench import spec

    cell = spec.resolve(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    sink = open(args.out, "w") if args.out else None
    try:
        for what in args.what.split(","):
            for seed in seeds:
                row = {"workload": cell.name, "what": what, "seed": seed,
                       "readings": readings(cell, seed, what, args.device, args.steps)}
                rows.append(row)
                line = json.dumps(row)
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
        line = json.dumps({"workload": cell.name, "summary": summary(rows)})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
