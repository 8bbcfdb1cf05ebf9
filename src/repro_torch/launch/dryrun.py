"""Multi-pod dry-run (port of ``repro/launch/dryrun.py``, deliverable e).

For every (architecture × input shape) cell, trace the real step function
(train_step / prefill / decode_step) sharded over the production mesh —
16×16 single-pod and 2×16×16 multi-pod — and record:

  * the per-device memory plan (``core/profiler.meta_memory`` of the local
    shards; the reference reads ``compiled.memory_analysis()``) — proves
    the per-device HBM plan fits;
  * per-device FLOPs / bytes for §Roofline (``core/hlo_cost.trace_cost``;
    the reference's ``compiled.cost_analysis()``);
  * per-kind collective bytes of the collectives the sharded step runs
    (``core/hlo_analysis``'s ring model; the reference parses them from
    the optimized HLO).

The reference compiles under ``--xla_force_host_platform_device_count=512``;
the port traces on meta tensors under :func:`~repro_torch.launch.mesh
.fake_world` of ``prod(mesh)`` ranks (a ``fake`` process group in this
one process, set up per mesh and torn down after it), so nothing is
allocated or launched on any device, and importing this module
initialises no process group.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \\
        --out build/repro_torch/dryrun.jsonl

``--device`` (default ``cuda``) is the deployment: its spec prices the
roofline (``engine.devices.from_torch_device()`` on the card,
``host_cpu`` for ``cpu``) and its type is the mesh's (NCCL's all-to-all on
``cuda``; gloo has none, so a ``cpu`` mesh gathers instead).  ``cuda``
raises without a card.

``--out`` (default ``build/repro_torch/dryrun.jsonl``) is an append-only
JSONL ledger with one record per cell, written through the
``core/fileio`` durable-append path (O_APPEND + fsync): an interrupted
run never leaves a torn ledger, and a restarted run skips the cells
already recorded instead of double-counting them.  A record holds the
reference's report keys and the port's ``sp``: the sequence-parallel hint
the cell ran with (``--no-sp`` turns it off; so does a torch whose
DTensor cannot view a sequence-sharded activation, and the run says so).
"""

from __future__ import annotations

import argparse
import math
import os
import traceback

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, cell_supported, get_config
from repro_torch.core.fileio import append_jsonl, load_jsonl_tolerant
from repro_torch.launch.lowering import lower_cell
from repro_torch.launch.mesh import fake_world, make_mesh

__all__ = ["main", "DEFAULT_OUT"]

DEFAULT_OUT = os.path.join("build", "repro_torch", "dryrun.jsonl")


def _cell_id(arch: str, shape: str, mesh_desc: str) -> str:
    return f"{arch}|{shape}|{mesh_desc}"


def _recorded_cells(path: str | None) -> set[str]:
    """Cell ids already present in the --out ledger (any status): a restart
    resumes where the interrupted run stopped instead of retracing —
    and re-appending — every earlier cell."""
    if not path:
        return set()
    done = set()
    for rec in load_jsonl_tolerant(path):
        if {"arch", "shape", "mesh"} <= rec.keys():
            done.add(_cell_id(rec["arch"], rec["shape"], rec["mesh"]))
    return done


def _hw(device: str):
    """The spec that prices the roofline: this card's, or the host's."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.engine.devices import from_torch_device, get_device

    dev = resolve_device(device)        # cuda without a card raises
    if dev.type == "cuda":
        return from_torch_device(torch.device("cuda"))
    return get_device("host_cpu")


def main(argv: list[str] | None = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=("off", "on", "both"), default="off")
    ap.add_argument("--mesh", default=None,
                    help="override mesh, e.g. 32x8 or 2x16x16 (axes inferred)")
    ap.add_argument("--out", default=DEFAULT_OUT, help="append JSONL reports here")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--opt", default="adamw", choices=("adamw", "sgdm"))
    ap.add_argument("--fsdp", default=None, choices=(None, "on", "off"))
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--loss-chunk", type=int, default=None)
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence-parallel residual-stream hint")
    ap.add_argument("--redo", action="store_true",
                    help="retrace cells already present in --out (the new "
                         "record is appended; readers keep the last one)")
    ap.add_argument("--device", default="cuda",
                    help="the deployment: cuda (default; this card's spec "
                         "prices the roofline) or cpu (the host_cpu spec)")
    args = ap.parse_args(argv)

    hw = _hw(args.device)
    mesh_device = "cuda" if args.device.startswith("cuda") else "cpu"
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)

    meshes: list[tuple[tuple, tuple, str]] = []
    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split("x"))
        meshes.append((dims, ("pod", "data", "model")[-len(dims):], args.mesh))
    else:
        if args.multi_pod in ("off", "both"):
            meshes.append(((16, 16), ("data", "model"), "16x16"))
        if args.multi_pod in ("on", "both"):
            meshes.append(((2, 16, 16), ("pod", "data", "model"), "2x16x16"))

    recorded = set() if args.redo else _recorded_cells(args.out)
    fsdp = None if args.fsdp is None else (args.fsdp == "on")
    results = []
    for dims, axes, mesh_desc in meshes:
        with fake_world(math.prod(dims)):
            mesh = make_mesh(dims, axes, device=mesh_device)
            for arch in archs:
                cfg = get_config(arch)
                for shape_name in shapes:
                    if _cell_id(arch, shape_name, mesh_desc) in recorded:
                        print(f"DONE {arch} × {shape_name} [{mesh_desc}] "
                              "(in ledger; --redo to retrace)", flush=True)
                        continue
                    ok, why = cell_supported(cfg, SHAPES[shape_name])
                    if not ok:
                        print(f"SKIP {arch} × {shape_name} [{mesh_desc}]: {why}",
                              flush=True)
                        if args.out:
                            append_jsonl(args.out, {
                                "arch": arch, "shape": shape_name,
                                "mesh": mesh_desc, "skipped": why,
                            })
                        continue
                    print(f"=== {arch} × {shape_name} [{mesh_desc}] ===", flush=True)
                    try:
                        rep = lower_cell(
                            arch, shape_name, mesh, mesh_desc,
                            opt_kind=args.opt, remat=not args.no_remat, fsdp=fsdp,
                            microbatches=args.microbatch, seq_chunk=args.loss_chunk,
                            sp=not args.no_sp, hw=hw,
                        )
                    except Exception:
                        traceback.print_exc()
                        print(f"FAILED {arch} × {shape_name} [{mesh_desc}]", flush=True)
                        if args.out:
                            append_jsonl(args.out, {
                                "arch": arch, "shape": shape_name,
                                "mesh": mesh_desc, "failed": True,
                            })
                        continue
                    print(rep.summary(), flush=True)
                    results.append(rep)
                    if args.out:
                        append_jsonl(args.out, rep.to_dict())

    print(f"\n{len(results)} cells traced OK")
    return results


if __name__ == "__main__":
    main()
