"""Campaign planning: enumerate, filter and subsample profiling grids
(port of ``repro/campaign/plan.py``, whole).

A campaign cell is one ``(arch × shape × mesh × device)`` coordinate —
exactly the grid perf4sight profiles once per device before fitting
(paper §5.1.1), lifted from CNN pruning grids to the LM workloads.  The
plan is a *value*: a seeded, hashed, JSON-serializable list of cells, so
two workers given the same plan file shard identically, and a fit artifact
can name the plan (``plan_hash``) it was grown from.

``SMOKE_SHAPES`` are the host-runnable miniatures of ``configs.base.SHAPES``
(reduced configs + tiny token counts): the tier-1 campaign smoke path and
the nightly accuracy benchmark both grid over them.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

import numpy as np

from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.configs.registry import ARCH_IDS, cell_supported, get_config
from repro_torch.core.fileio import atomic_write_json

__all__ = [
    "SMOKE_SHAPES",
    "CampaignCell",
    "CampaignPlan",
    "mesh_dims",
    "resolve_shape",
    "plan_grid",
    "smoke_plan",
    "collective_smoke_plan",
    "load_plan",
]

# Miniature workload shapes for host-CPU campaigns over reduced() configs.
# Same three kinds as the production SHAPES; token counts small enough that
# a full grid runs in seconds per cell on one CPU device.
SMOKE_SHAPES: dict[str, ShapeSpec] = {
    "smoke_train_16x2": ShapeSpec("smoke_train_16x2", 16, 2, "train"),
    "smoke_train_32x2": ShapeSpec("smoke_train_32x2", 32, 2, "train"),
    "smoke_train_32x4": ShapeSpec("smoke_train_32x4", 32, 4, "train"),
    "smoke_train_64x2": ShapeSpec("smoke_train_64x2", 64, 2, "train"),
    "smoke_train_64x4": ShapeSpec("smoke_train_64x4", 64, 4, "train"),
    "smoke_prefill_32x2": ShapeSpec("smoke_prefill_32x2", 32, 2, "prefill"),
    "smoke_prefill_64x2": ShapeSpec("smoke_prefill_64x2", 64, 2, "prefill"),
    "smoke_prefill_64x4": ShapeSpec("smoke_prefill_64x4", 64, 4, "prefill"),
}


def mesh_dims(desc: str) -> tuple[int, ...]:
    """``"2x16x16"`` → ``(2, 16, 16)`` (axes: pod/data/model, model last)."""
    try:
        dims = tuple(int(x) for x in str(desc).split("x"))
    except ValueError:
        raise ValueError(f"bad mesh descriptor {desc!r}; expected e.g. '1x1'") from None
    if not dims or any(d < 1 for d in dims):
        raise ValueError(f"bad mesh descriptor {desc!r}; dims must be >= 1")
    return dims


def resolve_shape(shape: "ShapeSpec | str") -> ShapeSpec:
    if isinstance(shape, ShapeSpec):
        return shape
    try:
        return SHAPES.get(shape) or SMOKE_SHAPES[shape]
    except KeyError:
        raise KeyError(
            f"unknown shape {shape!r}; known: "
            f"{sorted(SHAPES) + sorted(SMOKE_SHAPES)}") from None


@dataclass(frozen=True)
class CampaignCell:
    """One profiling coordinate.  ``key`` is a content hash — the ledger's
    primary key, stable across processes and plan re-enumerations."""

    arch: str
    shape: ShapeSpec
    mesh: str = "1x1"
    device: str = "host_cpu"
    reduced: bool = True

    @property
    def key(self) -> str:
        blob = json.dumps(
            {"arch": self.arch, "shape": [self.shape.name, self.shape.seq_len,
                                          self.shape.global_batch, self.shape.kind],
             "mesh": self.mesh, "device": self.device, "reduced": self.reduced},
            sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()

    def to_dict(self) -> dict:
        return {"arch": self.arch, "mesh": self.mesh, "device": self.device,
                "reduced": self.reduced,
                "shape": {"name": self.shape.name, "seq_len": self.shape.seq_len,
                          "global_batch": self.shape.global_batch,
                          "kind": self.shape.kind}}

    @classmethod
    def from_dict(cls, d: dict) -> "CampaignCell":
        s = d["shape"]
        return cls(arch=d["arch"], mesh=d.get("mesh", "1x1"),
                   device=d.get("device", "host_cpu"),
                   reduced=bool(d.get("reduced", True)),
                   shape=ShapeSpec(s["name"], int(s["seq_len"]),
                                   int(s["global_batch"]), s["kind"]))


@dataclass
class CampaignPlan:
    """A reproducible cell list: same inputs + seed → same cells, same hash."""

    cells: list[CampaignCell]
    seed: int = 0
    skipped: list[dict] = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    @property
    def plan_hash(self) -> str:
        blob = json.dumps([c.key for c in self.cells] + [self.seed])
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def save(self, path: str) -> None:
        atomic_write_json(path, {
            "plan_hash": self.plan_hash, "seed": self.seed, "meta": self.meta,
            "skipped": self.skipped,
            "cells": [c.to_dict() for c in self.cells],
        })

    def __len__(self) -> int:
        return len(self.cells)


def load_plan(path: str) -> CampaignPlan:
    with open(path) as f:
        d = json.load(f)
    plan = CampaignPlan(
        cells=[CampaignCell.from_dict(c) for c in d["cells"]],
        seed=int(d.get("seed", 0)), skipped=d.get("skipped", []),
        meta=d.get("meta", {}))
    want = d.get("plan_hash")
    if want and plan.plan_hash != want:
        raise ValueError(
            f"plan file {path} is inconsistent: stored hash {want} != "
            f"recomputed {plan.plan_hash} (edited by hand?)")
    return plan


def plan_grid(
    archs: tuple[str, ...] | None = None,
    shapes: tuple | None = None,
    meshes: tuple[str, ...] = ("1x1",),
    device: str = "host_cpu",
    *,
    reduced: bool = True,
    subsample: "int | float | None" = None,
    seed: int = 0,
) -> CampaignPlan:
    """Enumerate ``archs × shapes × meshes`` on one device, drop unsupported
    cells (``cell_supported`` with the mesh dims), and optionally subsample.

    Subsampling is *stratified by arch* with a seeded rng: every arch keeps
    a proportional share of its supported cells (at least one), so a small
    campaign still spans the architecture families instead of collapsing
    onto whichever arch enumerated first.  ``subsample`` is a cell count
    (int) or a fraction (float in (0, 1]).
    """
    archs = tuple(archs) if archs else ARCH_IDS
    shape_list = [resolve_shape(s) for s in (shapes or tuple(SHAPES))]

    cells: list[CampaignCell] = []
    skipped: list[dict] = []
    for arch in archs:
        cfg = get_config(arch, reduced=reduced)
        for shape in shape_list:
            for mesh in meshes:
                dims = mesh_dims(mesh)
                ok, why = cell_supported(cfg, shape, dims)
                if not ok:
                    skipped.append({"arch": arch, "shape": shape.name,
                                    "mesh": mesh, "why": why})
                    continue
                cells.append(CampaignCell(arch=arch, shape=shape, mesh=mesh,
                                          device=device, reduced=reduced))

    if subsample is not None and cells:
        if isinstance(subsample, float) and 0 < subsample <= 1:
            target = max(1, round(subsample * len(cells)))
        else:
            target = max(1, min(int(subsample), len(cells)))
        if target < len(cells):
            frac = target / len(cells)
            rng = np.random.default_rng(seed)
            by_arch: dict[str, list[CampaignCell]] = {}
            for c in cells:
                by_arch.setdefault(c.arch, []).append(c)
            kept: list[CampaignCell] = []
            # Deterministic iteration order (insertion = arch order) keeps
            # the rng stream — and therefore the plan hash — reproducible.
            for arch, group in by_arch.items():
                n = max(1, round(frac * len(group)))
                idx = rng.choice(len(group), size=min(n, len(group)),
                                 replace=False)
                kept.extend(group[i] for i in sorted(idx))
            cells = kept

    return CampaignPlan(cells=cells, seed=seed, skipped=skipped, meta={
        "archs": list(archs), "shapes": [s.name for s in shape_list],
        "meshes": list(meshes), "device": device, "reduced": reduced,
        "subsample": subsample,
    })


def smoke_plan(
    archs: tuple[str, ...] = ("qwen3-4b", "stablelm-1.6b"),
    shapes: tuple[str, ...] = tuple(SMOKE_SHAPES),
    *,
    device: str = "host_cpu",
    subsample: "int | None" = None,
    seed: int = 0,
) -> CampaignPlan:
    """The canonical host-CPU miniature campaign: reduced configs over the
    smoke shapes on a single-device mesh.  The tier-1 smoke test trims it
    to 4 cells via ``subsample``; the nightly benchmark runs it whole."""
    return plan_grid(archs=archs, shapes=shapes, meshes=("1x1",),
                     device=device, reduced=True, subsample=subsample,
                     seed=seed)


def collective_smoke_plan(
    archs: tuple[str, ...] = ("stablelm-1.6b",),
    shapes: tuple[str, ...] = ("smoke_train_16x2", "smoke_train_32x2"),
    *,
    device: str = "host_cpu",
    seed: int = 0,
) -> CampaignPlan:
    """The >1-device calibration grid: the same cells on ``1x1`` AND on the
    two minimal multi-device meshes (``2x1`` data-parallel, ``1x2``
    tensor-parallel), so the collective column of the class-wise NNLS
    (``fit.fit_hlo_constants``) spans nonzero values and the collective
    coefficient is fit on real measurements instead of staying at the
    ici_bw guess.  The plan is the reference's, cell for cell; the
    port's runner measures its multi-device cells over two ranks
    (``bench/engine_bench.collective_calibration``: two ``gloo`` CPU
    ranks) and quarantines them (``MeshSpecError``) with fewer."""
    return plan_grid(archs=archs, shapes=shapes,
                     meshes=("1x1", "2x1", "1x2"),
                     device=device, reduced=True, seed=seed)
