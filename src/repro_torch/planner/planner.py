"""Cost-model-driven auto-sharding: rank mesh layouts without running
them (port of ``repro/planner/planner.py``, whole).

``LayoutPlanner.plan`` answers "how should I split N devices between
data, tensor and pipeline parallelism for this (arch × shape)?" the same
way the admission gate answers "does it fit?": by asking the cost model,
never the device.  One base :class:`~repro_torch.engine.types.CostQuery`
(the single-device step) goes through the :class:`~repro_torch.engine.
engine.CostEngine` front door — forest-backed, cached, or analytical (a
trace of the step on meta tensors: no allocation, no launch) — and every
candidate layout is then priced *analytically* from that anchor:

* **compute** — the base step time divided by the useful parallelism.
  The model axis only speeds up what actually sharded:
  ``layout_collectives`` reports the replicated parameter fraction ``r``
  (fallback replication priced, per the sharding-rules contract), and
  Amdahl gives the model-axis efficiency ``1 / ((1-r)/M + r)``.
* **pipeline bubble** — ``bubble_fraction(P, n_micro)`` stretches the
  ideal stage time by ``1/(1-bubble)`` (GPipe fill/drain).
* **collectives** — the per-class byte counts derived from the actual
  partition specs, priced by ``engine.decompose.collective_seconds``
  (campaign-fitted collective coefficient when the device carries one,
  ici_bw roofline otherwise).
* **memory** — the base footprint scaled by the layout's per-device
  memory split (params/grads/opt/activations under TP+ZeRO+pipe) over
  the single-device split.
* **energy** — power-conserving: per-device step energy scales with the
  per-device step time; the fleet total multiplies by N.

Layouts that cannot run are *refused with a reason* (batch not divisible
by the data axis, layer stack not divisible by the pipe factor, memory
over capacity) and kept in the plan — a pruned layout is a documented
decision, not a silent hole.  Indivisible heads/dims are NOT a refusal:
the sharding rules fall back to replication and the planner prices that
fallback (extra model-axis all-reduce + unsplit memory), so a 40-head
arch on a 16-way model axis ranks badly instead of vanishing.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.configs.registry import get_config
from repro_torch.distributed.collectives import abstract_mesh, layout_collectives
from repro_torch.engine.decompose import collective_seconds
from repro_torch.engine.devices import resolve_device
from repro_torch.engine.types import CostQuery
from repro_torch.launch.mesh import validate_mesh_spec
from repro_torch.planner.layouts import MeshLayout, enumerate_layouts

__all__ = ["LayoutDecision", "LayoutRefusal", "LayoutPlan", "LayoutPlanner"]


@dataclass
class LayoutDecision:
    """One priced layout: predicted per-device (phi, gamma, energy) plus
    the additive breakdown the ranking came from."""

    layout: MeshLayout
    phi_ms: float
    gamma_mb: float
    energy_j: float          # per device, one step
    energy_total_j: float    # fleet (n_devices × per-device)
    breakdown: dict = field(default_factory=dict)
    collectives: dict = field(default_factory=dict)

    @property
    def sort_key(self) -> tuple:
        # Deterministic total order: latency, then fleet energy, then the
        # descriptor so exact ties break identically across processes.
        return (self.phi_ms, self.energy_total_j, self.layout.descriptor)

    def to_dict(self) -> dict:
        return {"layout": self.layout.to_dict(),
                "phi_ms": float(self.phi_ms),
                "gamma_mb": float(self.gamma_mb),
                "energy_j": float(self.energy_j),
                "energy_total_j": float(self.energy_total_j),
                "breakdown": dict(self.breakdown),
                "collectives": dict(self.collectives)}


@dataclass
class LayoutRefusal:
    """A layout the planner declined to rank, and exactly why."""

    layout: MeshLayout
    reason: str
    detail: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"layout": self.layout.to_dict(), "reason": self.reason,
                "detail": dict(self.detail)}


@dataclass
class LayoutPlan:
    """The ranked answer: ``ranked[0]`` (= :attr:`chosen`) is the predicted
    cheapest runnable layout; ``refused`` documents every pruned one."""

    arch: str
    shape: ShapeSpec
    n_devices: int
    device: str
    base: dict
    ranked: list = field(default_factory=list)
    refused: list = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    @property
    def chosen(self) -> LayoutDecision | None:
        return self.ranked[0] if self.ranked else None

    def decision_for(self, layout: "MeshLayout | str") -> LayoutDecision | None:
        desc = layout if isinstance(layout, str) else layout.descriptor
        for d in self.ranked:
            if d.layout.descriptor == desc:
                return d
        return None

    def to_dict(self) -> dict:
        return {
            "arch": self.arch,
            "shape": {"name": self.shape.name, "seq_len": self.shape.seq_len,
                      "global_batch": self.shape.global_batch,
                      "kind": self.shape.kind},
            "n_devices": self.n_devices,
            "device": self.device,
            "base": dict(self.base),
            "chosen": self.chosen.to_dict() if self.chosen else None,
            "ranked": [d.to_dict() for d in self.ranked],
            "refused": [r.to_dict() for r in self.refused],
            "meta": dict(self.meta),
        }

    def table(self, top: int | None = 10) -> str:
        """Ranked text table with the per-class collective breakdown —
        what ``python -m repro_torch.planner plan`` prints."""
        rows = self.ranked if top is None else self.ranked[:top]
        head = (f"{'#':>3} {'layout':>10} {'phi_ms':>12} {'gamma_mb':>11} "
                f"{'energy_j':>10} {'compute':>10} {'bubble%':>8} "
                f"{'coll_ms':>10} {'repl%':>6}")
        lines = [f"plan {self.arch} × {self.shape.name} on "
                 f"{self.n_devices}× {self.device} "
                 f"(base phi {self.base.get('phi_ms', 0.0):.3f} ms, "
                 f"source {self.base.get('source', '?')})", head]
        for i, d in enumerate(rows):
            b = d.breakdown
            lines.append(
                f"{i:>3} {d.layout.descriptor:>10} {d.phi_ms:>12.4f} "
                f"{d.gamma_mb:>11.1f} {d.energy_j:>10.3f} "
                f"{b.get('compute_ms', 0.0):>10.4f} "
                f"{100 * b.get('bubble', 0.0):>7.1f}% "
                f"{b.get('collective_ms', 0.0):>10.4f} "
                f"{100 * b.get('replicated_fraction', 0.0):>5.1f}%")
        for d in rows:
            per = d.breakdown.get("per_class_ms", {})
            busy = {k: v for k, v in per.items() if v}
            if busy:
                lines.append(
                    f"    {d.layout.descriptor}: " + "  ".join(
                        f"{k}={v:.4f}ms" for k, v in sorted(busy.items())))
        if self.refused:
            lines.append(f"refused {len(self.refused)}:")
            for r in self.refused:
                lines.append(f"    {r.layout.descriptor}: {r.reason}")
        return "\n".join(lines)


class LayoutPlanner:
    """Layout search over a :class:`CostEngine` that traces nothing
    beyond its one base query.

    ``engine`` answers the single base query (and is ``None``-able when
    ``base`` pins the anchor costs directly — offline planning from a
    known measurement).  ``device`` defaults to the engine's device and
    supplies the collective coefficient / ici_bw, the HBM capacity used
    for memory refusals, and the fleet-energy multiplier.
    """

    def __init__(self, engine=None, *, device=None, reduced: bool | None = None,
                 base: dict | None = None):
        if engine is None and base is None:
            raise ValueError("LayoutPlanner needs an engine or base costs")
        self.engine = engine
        dev = device
        if dev is None and engine is not None:
            dev = engine.device
        self.device = resolve_device(dev)
        self.reduced = reduced
        self.base = dict(base) if base else None

    # -- the anchor --------------------------------------------------------

    def base_estimate(self, arch: str, shape: ShapeSpec) -> dict:
        """The single-device step cost everything is scaled from: one
        (cacheable) engine query, or the pinned ``base`` dict."""
        if self.base is not None:
            return {"phi_ms": float(self.base.get("phi_ms", 0.0)),
                    "gamma_mb": float(self.base.get("gamma_mb", 0.0)),
                    "energy_j": float(self.base.get("energy_j", 0.0)),
                    "source": self.base.get("source", "pinned")}
        est = self.engine.estimate_one(CostQuery(
            arch=arch, bs=shape.global_batch, seq=shape.seq_len,
            stage="train" if shape.kind == "train" else "infer",
            reduced=self.reduced))
        return {"phi_ms": est.phi_ms, "gamma_mb": est.gamma_mb,
                "energy_j": est.energy_j, "source": est.source}

    # -- the search --------------------------------------------------------

    def plan(
        self,
        arch: str,
        shape: "ShapeSpec | str",
        n_devices: int,
        *,
        cfg: ArchConfig | None = None,
        max_pipe: int | None = None,
        n_micro: int = 8,
        check_memory: bool = True,
    ) -> LayoutPlan:
        """Enumerate, price and rank every (pipe × data × model) layout of
        ``n_devices`` for ``arch × shape``; see the module docstring for
        the pricing model.  ``max_pipe=1`` (what the training launcher
        passes — it has no pipeline schedule) removes the pipe dimension
        at enumeration time; ``check_memory=False`` keeps over-capacity
        layouts ranked instead of refused (capacity planning view)."""
        from repro_torch.campaign.plan import resolve_shape

        shape = resolve_shape(shape)
        if cfg is None:
            cfg = get_config(arch, reduced=bool(self.reduced))
        base = self.base_estimate(arch, shape)
        phi_base = float(base["phi_ms"])
        gamma_base = float(base["gamma_mb"])
        energy_base = float(base["energy_j"])
        dev = self.device
        cap_mb = dev.hbm_bytes / 1e6

        # The 1-device memory split anchors the gamma ratio: the engine's
        # base gamma already includes runtime overheads the analytic split
        # doesn't model, so layouts scale the *measured-or-predicted* base
        # by the *modelled* per-device ratio instead of trusting raw bytes.
        lc1 = layout_collectives(cfg, shape, abstract_mesh((1, 1)), pipe=1)
        mem1 = max(lc1.memory["total_bytes_dev"], 1.0)

        layouts = enumerate_layouts(n_devices, max_pipe=max_pipe)
        ranked: list[LayoutDecision] = []
        refused: list[LayoutRefusal] = []
        for lay in layouts:
            # The shared mesh validator (launch.mesh) vets the spec the
            # layout would build — same error surface as make_mesh.
            validate_mesh_spec(lay.mesh_shape, lay.mesh_axes)
            if shape.global_batch % lay.data:
                refused.append(LayoutRefusal(lay, (
                    f"global batch {shape.global_batch} not divisible by "
                    f"{lay.data}-way data parallelism"),
                    {"global_batch": shape.global_batch, "data": lay.data}))
                continue
            if lay.pipe > 1 and cfg.n_layers % lay.pipe:
                refused.append(LayoutRefusal(lay, (
                    f"layer stack {cfg.n_layers} not divisible into "
                    f"{lay.pipe} pipeline stages"),
                    {"n_layers": cfg.n_layers, "pipe": lay.pipe}))
                continue
            if lay.pipe > 1 and shape.global_batch % (lay.data * lay.pipe):
                refused.append(LayoutRefusal(lay, (
                    f"global batch {shape.global_batch} cannot form "
                    f"microbatches over {lay.data}-way data × "
                    f"{lay.pipe}-stage pipeline"),
                    {"global_batch": shape.global_batch,
                     "data": lay.data, "pipe": lay.pipe}))
                continue

            mesh = abstract_mesh(lay.mesh_shape, lay.mesh_axes)
            lc = layout_collectives(cfg, shape, mesh,
                                    pipe=lay.pipe, n_micro=n_micro)
            r = lc.replicated_fraction
            m = lay.model
            # Amdahl over the model axis: only the (1-r) sharded fraction
            # of the work speeds up M-fold; replicated leaves run whole on
            # every model-axis device.
            model_eff = 1.0 / ((1.0 - r) / m + r) if m > 1 else 1.0
            ideal_ms = phi_base / (lay.data * lay.pipe * model_eff)
            pipe_ms = ideal_ms / max(1.0 - lc.bubble, 1e-9)
            per_class_ms = {
                cls: float(collective_seconds(b, dev)) * 1e3
                for cls, b in lc.per_class.items()
            }
            coll_ms = sum(per_class_ms.values())
            phi_ms = pipe_ms + coll_ms

            mem_ratio = lc.memory["total_bytes_dev"] / mem1
            gamma_mb = gamma_base * mem_ratio
            if check_memory and gamma_mb > cap_mb:
                refused.append(LayoutRefusal(lay, (
                    f"predicted {gamma_mb:.0f} MB/device exceeds "
                    f"{dev.name} capacity {cap_mb:.0f} MB"),
                    {"gamma_mb": gamma_mb, "capacity_mb": cap_mb}))
                continue

            energy_j = (energy_base * phi_ms / phi_base
                        if phi_base > 0 else 0.0)
            ranked.append(LayoutDecision(
                layout=lay, phi_ms=phi_ms, gamma_mb=gamma_mb,
                energy_j=energy_j,
                energy_total_j=energy_j * lay.n_devices,
                breakdown={
                    "compute_ms": ideal_ms,
                    "bubble": lc.bubble,
                    "bubble_ms": pipe_ms - ideal_ms,
                    "collective_ms": coll_ms,
                    "per_class_ms": per_class_ms,
                    "model_efficiency": model_eff,
                    "replicated_fraction": r,
                    "mem_ratio": mem_ratio,
                },
                collectives=lc.to_dict(),
            ))

        ranked.sort(key=lambda d: d.sort_key)
        return LayoutPlan(
            arch=arch, shape=shape, n_devices=int(n_devices),
            device=dev.name, base=base, ranked=ranked, refused=refused,
            meta={
                "n_layouts": len(layouts),
                "n_ranked": len(ranked),
                "n_refused": len(refused),
                "max_pipe": max_pipe,
                "n_micro": int(n_micro),
                "reduced": self.reduced,
                "collective_coeff_fitted": bool(float(
                    (dev.class_coeffs.get("lm_latency") or {})
                    .get("collective", 0.0)) > 0.0),
            })
