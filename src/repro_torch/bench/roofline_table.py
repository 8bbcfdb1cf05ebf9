"""Roofline table (port of ``benchmarks/roofline_table.py``, deliverable
g): reads the dry-run JSONL (``repro_torch.launch.dryrun``'s ledger) and
prints the per-(arch × shape × mesh) roofline terms, dominant
bottleneck, usefulness ratio and HBM fit, with the reference's lines and
CSV.

    PYTHONPATH=src python -m repro_torch.bench.roofline_table [--path ...]
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.bench.common import csv_line
from repro_torch.launch.dryrun import DEFAULT_OUT

__all__ = ["load_reports", "run", "DRYRUN_PATH"]

DRYRUN_PATH = DEFAULT_OUT


def load_reports(path: str | None = None) -> list[dict]:
    path = path or DRYRUN_PATH
    if not os.path.exists(path):
        return []
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            key = (d.get("arch"), d.get("shape"), d.get("mesh"))
            out[key] = d  # last write wins (re-runs supersede)
    return list(out.values())


def run(print_fn=print, *, path: str | None = None, **_) -> list[dict]:
    reports = load_reports(path)
    if not reports:
        print_fn("roofline/no_data,0,run repro_torch.launch.dryrun first")
        return []
    header = (f"{'arch':>24s} {'shape':<12s} {'mesh':<9s} "
              f"{'C(ms)':>10s} {'M(ms)':>10s} {'X(ms)':>10s} "
              f"{'dom':<10s} {'useful':>6s} {'HBM(GB)':>8s} fit")
    print_fn(header)
    for d in sorted(reports, key=lambda d: (d.get("mesh", ""), d.get("arch", ""),
                                            d.get("shape", ""))):
        if d.get("skipped"):
            print_fn(f"{d['arch']:>24s} {d['shape']:<12s} {d['mesh']:<9s} "
                     f"SKIP: {d['skipped']}")
            continue
        if d.get("failed"):
            print_fn(f"{d['arch']:>24s} {d['shape']:<12s} {d['mesh']:<9s} FAILED")
            continue
        print_fn(
            f"{d['arch']:>24s} {d['shape']:<12s} {d['mesh']:<9s} "
            f"{d['compute_s'] * 1e3:10.2f} {d['memory_s'] * 1e3:10.2f} "
            f"{d['collective_s'] * 1e3:10.2f} {d['dominant']:<10s} "
            f"{d['useful_ratio']:6.2f} {d['per_device_hbm_gb']:8.2f} "
            f"{'OK' if d['fits_hbm'] else 'OVER'}"
        )
        print_fn(csv_line(
            f"roofline/{d['arch']}/{d['shape']}/{d['mesh']}/step_ms",
            d["step_s"] * 1e3,
            f"dom={d['dominant']} useful={d['useful_ratio']:.2f}",
        ))
    return reports


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default=None, help="the dry-run ledger (default "
                    f"{DRYRUN_PATH})")
    run(path=ap.parse_args().path)
