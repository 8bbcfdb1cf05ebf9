"""Campaign CLI: plan → run (resumable, shardable) → fit → status (port
of ``repro/campaign/__main__.py``).

    # 1. plan a grid (reproducible: same args + seed → same plan hash)
    PYTHONPATH=src python -m repro_torch.campaign plan --smoke \
        --out build/camp/plan.json

    # 2. run it on the card (--torch-device cpu for the plain CPU path) —
    #    restartable; shard across workers with --shard/--num-shards
    PYTHONPATH=src python -m repro_torch.campaign run \
        --plan build/camp/plan.json --ledger build/camp/ledger.jsonl

    # 3. fit the LM forest (+ optionally the cost-ledger device constants)
    PYTHONPATH=src python -m repro_torch.campaign fit \
        --ledger build/camp/ledger.jsonl --out build/camp/lm_forest.npz \
        --hlo-device-out build/camp/device.json

    # 4. where are we?
    PYTHONPATH=src python -m repro_torch.campaign status \
        --plan build/camp/plan.json --ledger build/camp/ledger.jsonl
"""

from __future__ import annotations

import argparse
import json

from repro_torch.campaign.fit import fit_hlo_constants, fit_lm_forest
from repro_torch.campaign.plan import (
    SMOKE_SHAPES,
    load_plan,
    plan_grid,
    smoke_plan,
)
from repro_torch.campaign.runner import CampaignLedger, CampaignRunner
from repro_torch.configs.base import SHAPES


def _cmd_plan(args) -> int:
    if args.smoke:
        plan = smoke_plan(subsample=args.subsample, seed=args.seed)
    else:
        plan = plan_grid(
            archs=tuple(args.arch) or None,
            shapes=tuple(args.shape) or None,
            meshes=tuple(args.mesh),
            device=args.device,
            reduced=not args.full_scale,
            subsample=args.subsample,
            seed=args.seed,
        )
    plan.save(args.out)
    print(f"plan {plan.plan_hash}: {len(plan)} cells "
          f"({len(plan.skipped)} skipped unsupported) -> {args.out}")
    return 0


def _cmd_run(args) -> int:
    from repro_torch.device import resolve_device

    resolve_device(args.torch_device)      # no card: refuse before reading
    plan = load_plan(args.plan)
    runner = CampaignRunner(
        plan, args.ledger, repeats=args.repeats, warmup=args.warmup,
        run=not args.compile_only, retry_failed=args.retry_failed,
        device=args.torch_device)
    out = runner.run_campaign(args.shard, args.num_shards,
                              max_cells=args.max_cells, print_fn=print)
    print(json.dumps(out))
    return 0 if out["remaining"] == 0 else 3  # 3 = come back for more


def _cmd_fit(args) -> int:
    ledger = CampaignLedger(args.ledger)
    records = ledger.records()
    forest = fit_lm_forest(records, device=args.device,
                           holdout_frac=args.holdout, seed=args.seed,
                           allow_mixed=args.allow_mixed)
    forest.save(args.out)
    print(f"LM forest -> {args.out}")
    print(json.dumps({k: v for k, v in forest.meta.items()
                      if k != "device_spec"}, indent=2, default=str))
    if args.hlo_device_out:
        from repro_torch.engine.devices import save_device_spec

        spec = fit_hlo_constants(records, base_device=args.device,
                                 allow_mixed=args.allow_mixed)
        save_device_spec(args.hlo_device_out, spec)
        print(f"calibrated LM DeviceSpec ({spec.name}, "
              f"{spec.meta['latency_fit']} fit, "
              f"phi MAPE {spec.meta['phi_mape']:.3f}, "
              f"energy {spec.meta.get('energy_fit', 'none')} fit)"
              f" -> {args.hlo_device_out}")
    return 0


def _breakdown(records: list[dict]) -> dict:
    """Aggregate the per-op-class ledger breakdown across ok-records: the
    'which op class is the money going to' view of a campaign.  The merge
    itself is ``CostLedger.merge_class_sums`` — one definition of a class
    bucket, shared with the ledger."""
    from repro_torch.costmodel import CostLedger

    with_classes = [r["cost_classes"] for r in records
                    if r.get("cost_classes")]
    totals = CostLedger.merge_class_sums(with_classes)
    flops_tot = sum(t["flops"] for t in totals.values()) or 1.0
    hbm_tot = sum(t["hbm_bytes"] for t in totals.values()) or 1.0
    # Schema-v3 records bucket per-class dynamic joules too; v2 buckets
    # merge as zero energy and the share column just stays 0.
    energy_tot = sum(t.get("energy_j", 0.0) for t in totals.values()) or 1.0
    return {
        "records_with_breakdown": len(with_classes),
        "classes": {
            cls: {
                **t,
                "flops_share": round(t["flops"] / flops_tot, 4),
                "hbm_share": round(t["hbm_bytes"] / hbm_tot, 4),
                "energy_share": round(t.get("energy_j", 0.0) / energy_tot, 4),
            }
            for cls, t in totals.items()
        },
    }


def _cmd_status(args) -> int:
    ledger = CampaignLedger(args.ledger)
    ok_recs = ledger.records("ok")
    out = {"ledger_records": len(ledger),
           "ok": len(ledger.ok_keys),
           "energy_j_total": round(sum(
               r.get("energy_j", 0.0) or 0.0 for r in ok_recs), 6),
           "quarantined": sorted(
               f"{r['arch']}×{r['shape']['name']}[{r['mesh']}]"
               for r in ledger.records("failed"))}
    if args.plan:
        plan = load_plan(args.plan)
        keys = {c.key for c in plan.cells}
        out.update(
            plan_hash=plan.plan_hash, plan_cells=len(plan),
            pending=len(keys - ledger.ok_keys - ledger.failed_keys),
            foreign_records=len(set(ledger._by_key) - keys),
        )
    if args.breakdown:
        out["breakdown"] = _breakdown(ok_recs)
    print(json.dumps(out, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.campaign")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("plan", help="enumerate + subsample a grid")
    p.add_argument("--arch", action="append", default=[],
                   help="arch id (repeatable; default: all)")
    p.add_argument("--shape", action="append", default=[],
                   help=f"shape name (repeatable; default: production SHAPES). "
                        f"known: {sorted(SHAPES) + sorted(SMOKE_SHAPES)}")
    p.add_argument("--mesh", action="append", default=["1x1"],
                   help="mesh dims like 1x1 or 2x16x16 (repeatable)")
    p.add_argument("--device", default="host_cpu")
    p.add_argument("--full-scale", action="store_true",
                   help="full (non-reduced) configs — production scale")
    p.add_argument("--subsample", type=float, default=None,
                   help="keep N cells (>=1) or a fraction (0..1), "
                        "stratified by arch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true",
                   help="the canonical host-CPU smoke grid (ignores "
                        "--arch/--shape/--mesh)")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=_cmd_plan)

    p = sub.add_parser("run", help="measure pending cells (resumable)")
    p.add_argument("--plan", required=True)
    p.add_argument("--ledger", required=True)
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--max-cells", type=int, default=None)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--compile-only", action="store_true",
                   help="no execution: the traced step's ledger and memory "
                        "only (phi_ms=0)")
    p.add_argument("--retry-failed", action="store_true",
                   help="re-measure quarantined cells too")
    p.add_argument("--torch-device", default="cuda",
                   help="where the steps run: cuda (default; raises without "
                        "a card) or cpu")
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("fit", help="fit LM forest (+ HLO constants)")
    p.add_argument("--ledger", required=True)
    p.add_argument("--out", required=True, help=".npz (packed) or .json")
    p.add_argument("--device", default=None,
                   help="featurize under this device (default: per-record)")
    p.add_argument("--holdout", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hlo-device-out", default=None,
                   help="also NNLS-fit the cost-ledger constants into a "
                        "calibrated DeviceSpec at this path")
    p.add_argument("--allow-mixed", action="store_true",
                   help="fit even when records were measured under different "
                        "device constants than the fit would featurize with "
                        "(the per-record fingerprint guard)")
    p.set_defaults(fn=_cmd_fit)

    p = sub.add_parser("status", help="ledger/plan progress")
    p.add_argument("--ledger", required=True)
    p.add_argument("--plan", default=None)
    p.add_argument("--breakdown", action="store_true",
                   help="also print the per-op-class cost breakdown "
                        "aggregated over ok records")
    p.set_defaults(fn=_cmd_status)

    args = ap.parse_args(argv)
    if args.cmd == "plan" and args.subsample is not None and args.subsample >= 1:
        args.subsample = int(args.subsample)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
