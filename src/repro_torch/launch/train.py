"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --reduced --steps 50 --ckpt-dir /tmp/ck --torch-device cpu

The reference's flags and its JSON summary.  ``--torch-device`` (default
``cuda``) is the device the port trains on; the reference's ``--device``
names a ``DeviceSpec`` for admission and keeps that meaning here.  Before
training the launcher warms the kernel tuning cache for the cell
(``warm_autotune(stages=("train",))``).

Admission through the cost engine is not ported yet: ``--device``,
``--memory-budget-gb``, ``--energy-budget-j`` and ``--estimate-cache``
wait on ``AnalyticalBackend``'s LM branch (ROADMAP.md, Queue 1, items
5a/5b), ``--lm-forest`` on ``LMForest`` (item 6), ``--auto-mesh`` and
``--n-micro`` on the planner (item 7); each raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models.transformer import warm_autotune
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["main"]

_ANALYTICAL = ("admission through the cost engine's LM branch "
               "(AnalyticalBackend, cost ledger) is not ported yet "
               "(ROADMAP.md, Queue 1, items 5a/5b)")
_WAITS_ON = {
    "device": _ANALYTICAL,
    "memory_budget_gb": _ANALYTICAL,
    "energy_budget_j": _ANALYTICAL,
    "estimate_cache": _ANALYTICAL,
    "lm_forest": "LMForest (campaign/) is not ported yet (ROADMAP.md, Queue 1, item 6)",
    "auto_mesh": "the auto-sharding planner is not ported yet (ROADMAP.md, Queue 1, item 7)",
    "n_micro": "the auto-sharding planner is not ported yet (ROADMAP.md, Queue 1, item 7)",
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--grad-compression", type=float, default=None)
    ap.add_argument("--torch-device", default="cuda",
                    help="where the port trains: cuda (default) or cpu")
    ap.add_argument("--device", default=None,
                    help="device registry name or calibrated DeviceSpec for "
                         "admission (not ported yet: items 5a/5b)")
    ap.add_argument("--memory-budget-gb", type=float, default=None,
                    help="admission memory budget (not ported yet: items 5a/5b)")
    ap.add_argument("--energy-budget-j", type=float, default=None,
                    help="admission energy budget (not ported yet: items 5a/5b)")
    ap.add_argument("--admission-margin", type=float, default=0.1,
                    help="safety margin on the predicted footprint; read only "
                         "with an admission budget")
    ap.add_argument("--estimate-cache", default=None,
                    help="the engine's estimate cache (not ported yet: items 5a/5b)")
    ap.add_argument("--lm-forest", default=None,
                    help="campaign-fitted LM forest (not ported yet: item 6)")
    ap.add_argument("--auto-mesh", type=int, default=None, metavar="N",
                    help="planner-chosen layout of N devices (not ported yet: item 7)")
    ap.add_argument("--n-micro", type=int, default=None,
                    help="the planner's microbatches (not ported yet: item 7)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = _parser().parse_args(argv)
    for flag, reason in _WAITS_ON.items():
        if getattr(args, flag) is not None:
            raise NotImplementedError(f"--{flag.replace('_', '-')}: {reason}")

    cfg = get_config(args.arch, reduced=args.reduced)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    opt = OptimizerConfig(kind="adamw", lr=args.lr, warmup_steps=10,
                          total_steps=max(args.steps, 100))
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         grad_compression=args.grad_compression)
    trainer = Trainer(cfg, shape, opt, tcfg, device=args.torch_device)

    # Pre-tune kernel block sizes for this cell (a meta-device trace): the
    # step then reads every block size from the device-keyed tuning cache.
    warm = warm_autotune(cfg, batch_size=args.batch, seq_len=args.seq,
                         stages=("train",))
    if warm["misses"]:
        print(f"autotune: {warm['misses']} kernel configs tuned "
              f"({warm['hits']} cached)")

    out = trainer.train(args.steps)
    h = out["history"]
    summary = {
        "arch": cfg.name,
        "steps": len(h),
        "first_loss": h[0]["loss"] if h else None,
        "last_loss": h[-1]["loss"] if h else None,
        "mean_step_ms": sum(r["dt"] for r in h) / max(len(h), 1) * 1e3,
        "stragglers": len(out["stragglers"]),
    }
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
