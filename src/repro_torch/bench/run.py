"""Entry point of the benchmarks: one runner per paper table or figure,
and the kernel and engine benches (port of ``benchmarks/run.py``).

Prints ``name,value,derived`` CSV lines.  All paper runners read the
port's profiling cache (``--cache``, default ``build/repro_torch/bench/
cnn_profile.json``; ``repro_torch.bench.collect_cnn_data`` fills it, and
missing points are profiled lazily on the card).  On the card each paper
runner also prints ``<name>/card_s`` with the datapoints it profiled and
the ``conv_mm`` launches it caused.  ``kernels`` (``kernel_bench.run``)
and ``engine`` (``engine_bench.run`` then ``planner_bench``) run on
``--device`` (default ``cuda``; ``cpu`` runs their plain paths).

    PYTHONPATH=src python -m repro_torch.bench.run [--only fig3,fig4] [--skip-slow]
    PYTHONPATH=src python -m repro_torch.bench.run --only kernels,engine [--device cpu]

``roofline`` (``roofline_table.run``) prints the rows of the dry-run's
ledger (``repro_torch.launch.dryrun``, default ``build/repro_torch/
dryrun.jsonl``).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
import traceback

# ROADMAP.md, queue 1: what each bench that is not ported waits for
NOT_PORTED: dict[str, str] = {}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated benchmark names")
    ap.add_argument("--skip-slow", action="store_true",
                    help="skip benches that may profile new configs")
    ap.add_argument("--cache", default=None, help="the profiling cache")
    ap.add_argument("--sub-cache", default=None, help="Table 2's sub-network cache")
    ap.add_argument("--device", default="cuda",
                    help="where kernels and engine run: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from . import (dnnmem_comparison, engine_bench, fig3_same_network, fig4_basis,
                   kernel_bench, roofline_table, strategy_variation,
                   table2_case_study, trainset_sweep)

    def engine(**_):
        engine_bench.run(device=args.device)
        engine_bench.planner_bench()

    benches = {
        "fig3": fig3_same_network.run,            # Fig. 3
        "fig4": fig4_basis.run,                   # Fig. 4
        "trainset": trainset_sweep.run,           # §6.1
        "dnnmem": dnnmem_comparison.run,          # §6.2.1
        "strategies": strategy_variation.run,     # §6.2 (100 strategies)
        "table2": table2_case_study.run,          # Table 2 / §6.4
        "roofline": roofline_table.run,           # deliverable g (dry-run)
        "kernels": lambda **_: kernel_bench.run(device=args.device),  # kernel μ-bench
        "engine": engine,                         # batched CostBackend API, planner
    }
    slow = {"strategies", "table2"}
    selected = (args.only.split(",") if args.only else list(benches))
    for name in selected:
        if name in NOT_PORTED:
            ap.error(f"{name} is not ported yet: it waits for {NOT_PORTED[name]}")
        if name not in benches:
            ap.error(f"unknown benchmark {name!r}; choose from {', '.join(benches)}")
    kw = {} if args.cache is None else {"cache_path": args.cache}

    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        card = f"not read ({e})"
    print(f"device {card}", flush=True)
    failures = []
    for name in selected:
        if args.skip_slow and name in slow:
            continue
        print(f"\n=== {name} ===", flush=True)
        t0 = time.time()
        try:
            if name == "table2" and args.sub_cache is not None:
                benches[name](sub_cache=args.sub_cache, **kw)
            else:
                benches[name](**kw)
        except Exception:
            traceback.print_exc()
            failures.append(name)
        print(f"=== {name} done in {time.time() - t0:.1f}s ===", flush=True)

    if failures:
        print(f"\nFAILED benchmarks: {failures}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
