#!/usr/bin/env python3
"""Whether a parameter draw on the host, run in a thread beside the
campaign's measured cells as ``chip_smoke.py``'s serve phase runs it,
moves the Φ the campaign records.  One card, one process.

    python3 scripts/host_draw_ab.py [--out build/host_draw_ab.json]

Builds the four Hopper kernels, then measures ``chip_smoke.py``'s campaign
plan three times, each into a fresh ledger on a fresh card tuner
(``chip_smoke.campaign_run``): alone, with ``chip_smoke.host_draw`` of
full-width qwen3-4b started just before (the serve phase's draw), and
alone again.  Prints, for each measured cell, the three Φ and the drawn
pass's ratio to the mean of the two lone passes; then the median and
extremes of that ratio, the lone passes' own ratio (the run-to-run spread
the draw's must stand out of), the draw's and the passes' seconds, and
the card line.  Writes the same as JSON to ``--out``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "host_draw_ab.json"))
    args = ap.parse_args()

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.conv_mm import kernel as ck
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_decode import kernel as pk
    from repro_torch.kernels.ssm_scan import kernel as sk

    if not torch.cuda.is_available():
        print("host_draw_ab: CUDA is not available", file=sys.stderr)
        return 1
    card = cs.card_line()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda w: w.load(), [pk.paged_decode_cuda, ck.conv_mm_cuda,
                                           fk.flash_attention_cuda, sk.ssd_chunk_cuda]))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)

    plan = cs.campaign_plan()
    passes, seconds, draw_s = {}, {}, None
    for tag in ("alone", "drawing", "alone_again"):
        drawing = cs.host_draw(get_config("qwen3-4b")) if tag == "drawing" else None
        t0 = time.perf_counter()
        records, _ = cs.campaign_run(plan)
        seconds[tag] = time.perf_counter() - t0
        if drawing is not None:
            model, draw_s = drawing.result()
            del model
        passes[tag] = {r["key"]: (f"{r['arch']} {r['shape']['name']}", r["phi_ms"])
                       for r in records}
        print(f"pass {tag}: {len(records)} cells measured in {seconds[tag]:.1f} s",
              flush=True)

    keys = [k for k in passes["alone"] if all(k in p for p in passes.values())]
    rows = []
    for k in keys:
        name = passes["alone"][k][0]
        a, d, b = (passes[t][k][1] for t in ("alone", "drawing", "alone_again"))
        rows.append({"cell": name, "alone_ms": a, "drawing_ms": d, "alone_again_ms": b,
                     "drawing_ratio": d / ((a + b) / 2), "alone_ratio": b / a})
        print(f"cell {name}: Φ alone {a:.3f} ms, drawing {d:.3f} ms, alone again "
              f"{b:.3f} ms; drawing / mean(alone) {rows[-1]['drawing_ratio']:.4f}, "
              f"alone again / alone {rows[-1]['alone_ratio']:.4f}")
    summary = {"card": card, "cells": len(rows), "draw_s": draw_s, "seconds": seconds}
    for key in ("drawing_ratio", "alone_ratio"):
        vals = [r[key] for r in rows]
        summary[key] = {"median": statistics.median(vals), "min": min(vals),
                        "max": max(vals)}
    print(json.dumps(summary))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"summary": summary, "rows": rows}, indent=1))
    print(f"device {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
