#!/usr/bin/env python3
"""Host wall time of a continuous-batching decode step, two checkouts of
the port compared on one card.

    python3 scripts/decode_step_ab.py PARENT_DIR CHANGE_DIR [--layers 12]

Runs one process per checkout in the order parent, change, change, parent
(so drift on the host shows as a difference between the two parent runs).
Each builds qwen3-4b at full width with its depth cut to ``--layers``
(random bf16 weights, seed 0), fills all 8 slots of
``ContinuousEngine(n_slots=8, max_len=2048, prefill_chunk=512)`` with
256-token prompts, runs 6 warm-up steps (tuner searches, if the checkout
has a tuner, happen there, on a fresh cache) and then times 30 decode
steps one by one, each ended by ``torch.cuda.synchronize``.  Prints one
JSON line per run (median and quartiles of the per-step host wall, in ms)
and the card line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

_CHILD = r"""
import dataclasses, json, statistics, sys, time
sys.path.insert(0, sys.argv[1] + "/src")
import numpy as np
import torch
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as T
from repro_torch.serve import ContinuousConfig, ContinuousEngine, Request

cfg = dataclasses.replace(get_config("qwen3-4b"), n_layers=int(sys.argv[2]))
params = T.init_params(cfg, 0, device="cuda")
scfg = ContinuousConfig(n_slots=8, max_len=2048, prefill_chunk=512, eos_id=-1)
engine = ContinuousEngine(cfg, params, scfg)
rng = np.random.default_rng(0)
for _ in range(8):
    engine.submit(Request(rng.integers(2, cfg.vocab, (256,)).astype(np.int32),
                          max_new_tokens=64))
for _ in range(6):
    engine.step()
times = []
for _ in range(30):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.step()
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
q = statistics.quantiles(times, n=4)
print(json.dumps({"tree": sys.argv[1], "layers": cfg.n_layers,
                  "host_ms_median": statistics.median(times),
                  "host_ms_q1": q[0], "host_ms_q3": q[2]}))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--layers", type=int, default=12)
    args = ap.parse_args()
    rows = []
    for label, tree in (("parent", args.parent), ("change", args.change),
                        ("change", args.change), ("parent", args.parent)):
        with tempfile.TemporaryDirectory(dir=os.path.abspath(tree)) as tmp:
            env = dict(os.environ,
                       REPRO_TORCH_TUNING_CACHE=os.path.join(tmp, "tune.json"))
            out = subprocess.run(
                [sys.executable, "-c", _CHILD, os.path.abspath(tree),
                 str(args.layers)], env=env, capture_output=True, text=True,
                check=True)
        row = json.loads(out.stdout.strip().splitlines()[-1])
        row["label"] = label
        rows.append(row)
        print(json.dumps(row), flush=True)
    for label in ("parent", "change"):
        med = statistics.median(r["host_ms_median"] for r in rows
                                if r["label"] == label)
        print(f"{label}: median of run medians {med:.2f} ms/step")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"device {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
