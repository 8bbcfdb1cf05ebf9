"""Planner CLI: rank mesh layouts for an (arch × shape × device count)
(port of ``repro/planner/__main__.py``: the same flags, defaults, output
and exit codes — 0, 4 when nothing is runnable, 2 for a layout of another
device count or one not enumerated).

    # rank every layout of 256 devices for the production train cell
    PYTHONPATH=src python -m repro_torch.planner plan --arch qwen3-4b \
        --shape train_4k --devices 256 --device tpu_v5e

    # offline: anchor on known base costs instead of running the engine
    PYTHONPATH=src python -m repro_torch.planner plan --arch qwen3-4b \
        --shape train_4k --devices 16 --device tpu_v5e \
        --base-phi-ms 120 --base-gamma-mb 9000 --base-energy-j 18

    # why was a specific layout ranked/refused where it was?
    PYTHONPATH=src python -m repro_torch.planner explain --arch qwen3-4b \
        --shape train_4k --devices 256 --device tpu_v5e --layout 1x16x16
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.planner.layouts import MeshLayout
from repro_torch.planner.planner import LayoutPlanner


def _build_planner(args) -> LayoutPlanner:
    if args.base_phi_ms is not None:
        base = {"phi_ms": args.base_phi_ms,
                "gamma_mb": args.base_gamma_mb or 0.0,
                "energy_j": args.base_energy_j or 0.0,
                "source": "cli"}
        return LayoutPlanner(device=args.device, reduced=args.reduced,
                             base=base)
    from repro_torch.engine import (
        AnalyticalBackend,
        CostEngine,
        EnsembleBackend,
        ForestBackend,
        resolve_device,
    )

    device = resolve_device(args.device)
    chain = []
    if args.lm_forest:
        from repro_torch.campaign import LMForest

        chain.append(ForestBackend(lm=LMForest.load(args.lm_forest)))
    chain.append(AnalyticalBackend(reduced=args.reduced, lm_device=device))
    engine = CostEngine(EnsembleBackend(chain), cache=args.estimate_cache,
                        device=device)
    return LayoutPlanner(engine, reduced=args.reduced)


def _shape(args) -> "ShapeSpec | str":
    if args.shape:
        return args.shape
    return ShapeSpec("cli", args.seq, args.batch, args.kind)


def _cmd_plan(args) -> int:
    planner = _build_planner(args)
    plan = planner.plan(args.arch, _shape(args), args.devices,
                        max_pipe=args.max_pipe, n_micro=args.n_micro,
                        check_memory=not args.no_memory_check)
    if args.out:
        from repro_torch.core.fileio import atomic_write_json

        atomic_write_json(args.out, plan.to_dict())
    if args.json:
        print(json.dumps(plan.to_dict(), indent=2))
    else:
        print(plan.table(top=args.top))
    return 0 if plan.chosen is not None else 4  # 4 = nothing runnable


def _cmd_explain(args) -> int:
    planner = _build_planner(args)
    plan = planner.plan(args.arch, _shape(args), args.devices,
                        max_pipe=args.max_pipe, n_micro=args.n_micro,
                        check_memory=not args.no_memory_check)
    lay = MeshLayout.parse(args.layout)
    if lay.n_devices != args.devices:
        print(f"layout {lay.descriptor} uses {lay.n_devices} devices, "
              f"not --devices {args.devices}")
        return 2
    dec = plan.decision_for(lay)
    if dec is not None:
        rank = next(i for i, d in enumerate(plan.ranked)
                    if d.layout == dec.layout)
        print(json.dumps({"rank": rank, "of": len(plan.ranked),
                          "chosen": rank == 0, **dec.to_dict()}, indent=2))
        return 0
    for r in plan.refused:
        if r.layout == lay:
            print(json.dumps({"refused": True, **r.to_dict()}, indent=2))
            return 0
    print(f"layout {lay.descriptor} was not enumerated "
          f"(max_pipe={args.max_pipe})")
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.planner")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--arch", required=True, choices=ARCH_IDS)
        p.add_argument("--devices", type=int, required=True,
                       help="device count to factorize into pipe×data×model")
        p.add_argument("--shape", default=None,
                       help=f"named shape ({sorted(SHAPES)} or a smoke "
                            "shape); overrides --seq/--batch/--kind")
        p.add_argument("--seq", type=int, default=4096)
        p.add_argument("--batch", type=int, default=256)
        p.add_argument("--kind", default="train",
                       choices=("train", "prefill", "decode"))
        p.add_argument("--device", default="tpu_v5e",
                       help="device registry name or DeviceSpec path — "
                            "supplies the collective coefficient / ici_bw "
                            "and the HBM capacity for memory refusals")
        p.add_argument("--reduced", action="store_true",
                       help="smoke-scale config (CPU-runnable base query)")
        p.add_argument("--max-pipe", type=int, default=None,
                       help="cap the pipeline factor (1 = no pipelining)")
        p.add_argument("--n-micro", type=int, default=8,
                       help="microbatches per step for the bubble model")
        p.add_argument("--no-memory-check", action="store_true",
                       help="rank over-capacity layouts instead of "
                            "refusing them")
        p.add_argument("--lm-forest", default=None,
                       help="campaign-fitted LM forest: the base query is "
                            "answered with zero compiles")
        p.add_argument("--estimate-cache", default=None)
        p.add_argument("--base-phi-ms", type=float, default=None,
                       help="pin the single-device step latency (engine-"
                            "free offline planning)")
        p.add_argument("--base-gamma-mb", type=float, default=None)
        p.add_argument("--base-energy-j", type=float, default=None)

    p = sub.add_parser("plan", help="rank every layout, print the table")
    common(p)
    p.add_argument("--top", type=int, default=10,
                   help="rows to print (refusals always listed)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--out", default=None,
                   help="also write the full plan as JSON")
    p.set_defaults(fn=_cmd_plan)

    p = sub.add_parser("explain",
                       help="where did one layout rank, and why?")
    common(p)
    p.add_argument("--layout", required=True,
                   help="PxDxM descriptor, e.g. 1x16x16")
    p.set_defaults(fn=_cmd_explain)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
