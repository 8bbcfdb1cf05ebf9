"""Training launcher with perf4sight admission control (port of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --reduced --steps 50 --ckpt-dir /tmp/ck --torch-device cpu

The reference's flags and its JSON summary.  ``--torch-device`` (default
``cuda``) is the device the port trains on; the reference's ``--device``
names a ``DeviceSpec`` for admission and keeps that meaning here.

Before anything is drawn, the launcher asks the cost engine
(``repro_torch.engine``) for the training step's footprint — with
``--lm-forest``, a campaign-fitted ``LMForest`` first
(``ForestBackend(lm=LMForest.load(path))``: no trace, nothing on the
card), then the ``AnalyticalBackend``'s LM branch for what the forest
cannot answer: the step (``loss_fn``, backward, AdamW) traced on meta
tensors, its aten-op ledger priced by the device's roofline, no
execution — and refuses a job over ``--memory-budget-gb`` or
``--energy-budget-j`` (inflated by ``--admission-margin``), or over the
``--device``'s capacity, with :class:`PlacementRefused` (the paper's §6.4
safety property).  Estimates are cached on disk (``--estimate-cache``), so
re-launching the same cell readmits with no new trace.  Then it warms the
kernel tuning cache for the cell (``warm_autotune(stages=("train",))``).

``--auto-mesh N`` asks the planner (``repro_torch.planner``) for the
cheapest data × model layout of N devices (``max_pipe=1``: the trainer
has no pipeline schedule; ``--n-micro`` feeds its bubble model) through
the same engine, prints the ranked table before any parameter is drawn,
raises ``RuntimeError`` naming every refusal when no layout is runnable,
and reports the chosen layout's costs in the admission ``info``
(``auto_mesh``).  The devices are the ranks started for the job
(``torchrun``, or the ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``
environment; one without): a layout of N of them initialises the
process group (``nccl`` on the cards, ``gloo`` on the CPU) unless it is
up, builds the chosen mesh (``launch.mesh.make_mesh``) and trains on it
(``Trainer(mesh=...)``); a layout of more devices than there are ranks
is reported and training runs unsharded, as in the reference on a short
host; a layout of one device trains unsharded.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models.transformer import warm_autotune
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.serve.scheduler import PlacementRefused
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["main"]

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
                    help="device registry name (host_cpu, tx2_like, tpu_v5e, "
                         "h100) or path to a calibrated DeviceSpec (.json/.npz) "
                         "— sets the admission roofline constants and, absent "
                         "--memory-budget-gb, the memory capacity budget")
    ap.add_argument("--memory-budget-gb", type=float, default=None,
                    help="admission gate: refuse if predicted memory (inflated "
                         "by --admission-margin) exceeds this; defaults to "
                         "the --device capacity when a device is given")
    ap.add_argument("--energy-budget-j", type=float, default=None,
                    help="admission gate: refuse if the predicted step "
                         "energy (inflated by --admission-margin) exceeds "
                         "this many joules")
    ap.add_argument("--admission-margin", type=float, default=0.1,
                    help="safety margin applied to the predicted footprint "
                         "before comparing to the budget (0 = exact)")
    ap.add_argument("--estimate-cache", default=None,
                    help="JSON path for the engine's on-disk estimate cache")
    ap.add_argument("--lm-forest", default=None,
                    help="campaign-fitted LMForest (.npz/.json from "
                         "`python -m repro_torch.campaign fit`): answer LM "
                         "admission with no trace, falling back to the "
                         "analytical trace only for cells the forest cannot "
                         "answer")
    ap.add_argument("--auto-mesh", type=int, default=None, metavar="N",
                    help="let the auto-sharding planner (repro_torch.planner) "
                         "pick the cheapest data×model layout of N devices "
                         "for this cell (max_pipe=1: the trainer has no "
                         "pipeline schedule) and train on it over the ranks "
                         "torchrun started; with fewer ranks it reports the "
                         "plan and trains unsharded")
    ap.add_argument("--n-micro", type=int, default=8,
                    help="microbatches per step assumed by the planner's "
                         "pipeline-bubble model")
    return ap


def _engine(args):
    """The cost engine admission and the planner ask, or None when no
    admission or planner flag is given."""
    if (args.memory_budget_gb is None and args.device is None
            and args.lm_forest is None and args.energy_budget_j is None
            and args.auto_mesh is None):
        return None
    from repro_torch.engine import (
        AnalyticalBackend,
        CostEngine,
        EnsembleBackend,
        ForestBackend,
        resolve_device,
    )

    device = resolve_device(args.device) if args.device else None
    chain = []
    if args.lm_forest:
        from repro_torch.campaign import LMForest

        chain.append(ForestBackend(lm=LMForest.load(args.lm_forest)))
    chain.append(AnalyticalBackend(reduced=args.reduced, lm_device=device))
    return CostEngine(EnsembleBackend(chain), cache=args.estimate_cache,
                      device=device)


def _world() -> int:
    """The ranks started for this job: the initialised group's, torchrun's
    (or the ``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` environment's), else
    one."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    if {"RANK", "WORLD_SIZE", "MASTER_ADDR"} <= os.environ.keys():
        return int(os.environ["WORLD_SIZE"])
    return 1


def _build_mesh(chosen, torch_device):
    """The chosen layout's ``DeviceMesh`` over the job's ranks, the process
    group initialised from the environment if it is not up yet."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    if not dist.is_initialized():
        if torch_device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
        dist.init_process_group("nccl" if torch_device.type == "cuda" else "gloo")
    return make_mesh(chosen.mesh_shape, chosen.mesh_axes, device=torch_device.type)


def _auto_mesh(args, engine, shape):
    """The planner's ranked layouts of ``--auto-mesh`` devices, printed,
    and the chosen layout's mesh when the job has its ranks (else None);
    an empty plan raises naming every refusal."""
    from repro_torch.planner import LayoutPlanner

    plan = LayoutPlanner(engine, reduced=args.reduced).plan(
        args.arch, shape, args.auto_mesh, max_pipe=1, n_micro=args.n_micro)
    print(plan.table(top=5))
    if plan.chosen is None:
        raise RuntimeError(
            f"auto-mesh: no runnable layout of {args.auto_mesh} devices for "
            f"{args.arch} × {shape.name}; refused: "
            + "; ".join(f"{r.layout.descriptor}: {r.reason}" for r in plan.refused))
    chosen = plan.chosen.layout
    torch_device = torch.device(args.torch_device)
    world = _world()
    if chosen.n_devices > world:
        print(f"auto-mesh: {chosen.descriptor} needs {chosen.n_devices} devices, "
              f"host has {world} — plan reported, training unsharded")
        return plan, None
    if chosen.n_devices == 1:
        print(f"auto-mesh: {chosen.descriptor} is one device — training unsharded")
        return plan, None
    if chosen.n_devices < world:
        raise ValueError(f"auto-mesh: {chosen.descriptor} takes {chosen.n_devices} of "
                         f"the job's {world} ranks; start as many ranks as the layout "
                         "has devices")
    mesh = _build_mesh(chosen, torch_device)
    print(f"auto-mesh: built {chosen.descriptor} ({chosen.data}-way data × "
          f"{chosen.model}-way model)")
    return plan, mesh


def _admission(args, engine, plan):
    """The admission callable the ``Trainer`` asks before it builds the
    step, or None without an engine.  A refusal raises
    :class:`PlacementRefused` (a ``RuntimeError``, "admission denied")."""
    if engine is None:
        return None
    from repro_torch.engine import CostQuery

    device = engine.device if args.device else None

    def admission(cfg, shape):
        ok, info = engine.admit(
            CostQuery(arch=args.arch, bs=shape.global_batch, seq=shape.seq_len,
                      stage="train", reduced=args.reduced),
            gamma_budget_mb=(args.memory_budget_gb * 1e3
                             if args.memory_budget_gb is not None else None),
            energy_budget_j=args.energy_budget_j,
            safety_margin=args.admission_margin,
        )
        info["predicted_gb"] = info["gamma_mb"] / 1e3
        info["predicted_energy_j"] = info["energy_j"]
        if device is not None:
            info["device"] = device.name
        if plan is not None:
            # the planner-chosen layout's predicted costs, reported at
            # admission beside the single-device gate
            c = plan.chosen
            info["auto_mesh"] = {"layout": c.layout.descriptor, "phi_ms": c.phi_ms,
                                 "gamma_mb": c.gamma_mb, "energy_j": c.energy_j}
        if not ok:
            raise PlacementRefused(f"admission denied: {info}", info)
        return ok, info

    return admission


def main(argv: list[str] | None = None) -> dict:
    args = _parser().parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    engine = _engine(args)
    plan, mesh = (_auto_mesh(args, engine, shape) if args.auto_mesh is not None
                  else (None, None))
    opt = OptimizerConfig(kind="adamw", lr=args.lr, warmup_steps=10,
                          total_steps=max(args.steps, 100))
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         grad_compression=args.grad_compression)
    # admission runs in the Trainer's constructor: a refusal raises before
    # any parameter is drawn
    trainer = Trainer(cfg, shape, opt, tcfg, admission=_admission(args, engine, plan),
                      device=args.torch_device,
                      **({"mesh": mesh} if mesh is not None else {}))

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
