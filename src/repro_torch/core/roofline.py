"""Roofline analysis of a traced step (port of ``repro/core/roofline.py``).

Per (arch × shape × device) cell, the three roofline terms of one step:

    compute term    = ledger FLOPs      / peak FLOP/s
    memory term     = ledger HBM bytes  / HBM bandwidth
    collective term = collective bytes  / link bandwidth

The reference derives them from an AOT-compiled XLA executable
(``roofline_from_compiled``); the port from the aten-op ledger of a
meta-tensor trace (:func:`~repro_torch.core.hlo_cost.trace_cost`), through
:func:`roofline_from_cost`.  The hardware is always a required
:class:`~repro_torch.engine.devices.DeviceSpec` (or its ``hw_table()``
dict): the reference's ``TPU_V5E`` default does not enter the port.

MODEL_FLOPS = 6·N·D (training; N = active parameters, D = tokens) or
2·N·D (a forward) per device, and the usefulness ratio MODEL_FLOPS /
ledger FLOPs — low values flag remat and blocked-attention overcompute.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from dataclasses import field as dataclasses_field

__all__ = ["RooflineReport", "roofline_from_cost", "model_flops_for_cell"]


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    # raw per-device quantities
    flops: float
    hbm_bytes: float
    collective_bytes: float
    bytes_by_kind: dict
    # terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    step_s: float               # max of the three (no-overlap bound)
    # usefulness
    model_flops: float          # 6·N·D (train) / 2·N·D (fwd) per device
    useful_ratio: float
    # memory plan
    per_device_hbm_gb: float
    fits_hbm: bool
    compile_s: float = 0.0      # the trace's seconds (the reference's key)
    # per-op-class attribution: {cls: {flops, hbm_bytes, collective_bytes,
    # energy_j, count}} + the top ledger records
    class_breakdown: dict = dataclasses_field(default_factory=dict)
    top_ops: list = dataclasses_field(default_factory=list)
    # the port's one key beyond the reference's: the sequence-parallel hint
    # the step ran with (False on one device)
    sp: bool = False

    def to_dict(self) -> dict:
        return asdict(self)

    def summary(self) -> str:
        lines = [
            f"{self.arch:>24s} {self.shape:<12s} {self.mesh:<9s} "
            f"C={self.compute_s * 1e3:9.2f}ms M={self.memory_s * 1e3:9.2f}ms "
            f"X={self.collective_s * 1e3:9.2f}ms dom={self.dominant:<10s} "
            f"useful={self.useful_ratio:5.2f} hbm={self.per_device_hbm_gb:6.2f}GB"
            f"{'' if self.fits_hbm else ' OVER'} [trace {self.compile_s:.0f}s]"
        ]
        if self.class_breakdown:
            parts = []
            for cls, s in self.class_breakdown.items():
                share = s["hbm_bytes"] / self.hbm_bytes if self.hbm_bytes else 0.0
                parts.append(f"{cls}={share:.0%}")
            lines.append(" " * 25 + "bytes by class: " + " ".join(parts))
        for op in self.top_ops:
            share = op["hbm_bytes"] / self.hbm_bytes if self.hbm_bytes else 0.0
            lines.append(
                " " * 25 + f"top op {op['op']:<20s} [{op['op_class']}] "
                f"{op['hbm_bytes'] / 1e6:10.1f}MB ({share:.0%}) "
                f"x{op['trip_multiplier']:.0f} @{op['origin']}")
        return "\n".join(lines)


def roofline_from_cost(
    cost,
    *,
    arch: str,
    shape: str,
    mesh_desc: str,
    n_devices: int,
    model_flops_total: float,
    hw,
    plan_bytes: float,
    compile_s: float = 0.0,
    sp: bool = False,
) -> RooflineReport:
    """The report of one traced step: ``cost`` is its
    :class:`~repro_torch.core.hlo_cost.HloCost`, ``hw`` a ``DeviceSpec``
    (or its ``hw_table()``), ``plan_bytes`` the step's Γ in bytes (the
    reference reads it from XLA's ``memory_analysis``; the port from
    :func:`~repro_torch.core.profiler.meta_memory`)."""
    if hasattr(hw, "hw_table"):
        hw = hw.hw_table()
    flops = cost.flops
    hbm = cost.hbm_bytes
    compute_s = flops / hw["peak_flops_bf16"]
    memory_s = hbm / hw["hbm_bw"]
    coll_s = cost.collective_bytes / hw["ici_bw"]
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)

    model_flops_dev = model_flops_total / n_devices
    top_ops = [
        {"op": r.op, "op_class": r.op_class, "flops": r.flops,
         "hbm_bytes": r.hbm_bytes, "collective_bytes": r.collective_bytes,
         "trip_multiplier": r.trip_multiplier, "origin": r.origin}
        for r in cost.ledger.top_k(3, by="hbm_bytes")
    ]
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_desc,
        n_devices=n_devices,
        flops=flops,
        hbm_bytes=hbm,
        collective_bytes=cost.collective_bytes,
        bytes_by_kind=dict(cost.bytes_by_kind),
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=coll_s,
        dominant=dominant,
        step_s=max(terms.values()),
        model_flops=model_flops_dev,
        useful_ratio=(model_flops_dev / flops) if flops else 0.0,
        per_device_hbm_gb=plan_bytes / 1e9,
        fits_hbm=plan_bytes <= hw["hbm_bytes"],
        compile_s=compile_s,
        sp=sp,
        class_breakdown=cost.ledger.class_sums(),
        top_ops=top_ops,
    )


def model_flops_for_cell(cfg, shape) -> float:
    """Total MODEL_FLOPS across devices for one step of this cell."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq
