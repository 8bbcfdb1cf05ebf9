"""The train-step compute/byte decomposition — single source of truth
(port of ``repro/engine/decompose.py``, numpy only, held exactly).

The calibration fit (``engine/calibrate.py``) solves for device constants
over exactly these regressors, and the analytical prediction path
(``engine/backends.AnalyticalBackend``) multiplies the same regressors by
the fitted constants.  They MUST stay byte-identical: a drift between the
two (e.g. one side changing what counts as "bytes moved") silently skews
every calibrated prediction with nothing failing loudly.  Hence one
module, consumed by both.

All CNN functions take a ``(N, F)`` Appendix-B feature matrix (rows =
workloads, columns = ``core.features.FEATURE_NAMES`` order, train stage)
and return per-row arrays.

``price_ledger_energy`` stamps each record of a
:class:`~repro_torch.costmodel.CostLedger` with its dynamic energy, as
the reference does: the same ledger and device give bit-identical
``energy_j`` in both packages.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from repro_torch.core.features import FEATURE_NAMES
from repro_torch.costmodel import OP_CLASSES, CostLedger

__all__ = [
    "latency_terms",
    "memory_terms",
    "lm_roofline_terms",
    "energy_terms",
    "watts_proxy",
    "price_ledger_energy",
    "cnn_energy_class_joules",
    "CNN_LATENCY_COLUMNS",
    "latency_class_columns",
    "LM_LATENCY_COLUMNS",
    "ledger_latency_columns",
    "classwise_seconds",
    "collective_seconds",
]

_I_W = FEATURE_NAMES.index("mem_w")
_I_IFM = FEATURE_NAMES.index("mem_ifm_grad")
_I_OFM = FEATURE_NAMES.index("mem_ofm_grad")
_I_ALLOC = FEATURE_NAMES.index("mem_alloc_total")
_I_OPS = FEATURE_NAMES.index("mm_ops_sum")
_I_I2C = FEATURE_NAMES.index("mm_i2c_total_sum")


def latency_terms(feats: np.ndarray, bytes_per_el: int) -> tuple[np.ndarray, np.ndarray]:
    """(flops, bytes_moved) per training-step workload: FLOPs are 2× the
    fwd+bwd MAC count; traffic is the allocation total plus the im2col
    lowering volume."""
    F = np.atleast_2d(np.asarray(feats, dtype=np.float64))
    flops = 2.0 * F[:, _I_OPS]
    bytes_moved = bytes_per_el * (F[:, _I_ALLOC] + F[:, _I_I2C])
    return flops, bytes_moved


def lm_roofline_terms(
    flops, hbm_bytes, collective_bytes, device
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """LM-cell analogue of :func:`latency_terms`: the three roofline seconds
    (compute, memory, collective) a device spec turns op counts into.
    Inputs may be scalars or arrays; outputs follow numpy broadcasting."""
    flops = np.asarray(flops, dtype=np.float64)
    hbm_bytes = np.asarray(hbm_bytes, dtype=np.float64)
    collective_bytes = np.asarray(collective_bytes, dtype=np.float64)
    return (flops / device.peak_flops, hbm_bytes / device.hbm_bw,
            collective_bytes / device.ici_bw)


# ---------------------------------------------------------------------------
# Energy (PowerTrain-style: board power = idle + dynamic × utilisation).
#
# The dynamic energy of a roofline phase is its busy time × the device's
# dynamic power range, so every term below is an existing latency term
# multiplied by ``dynamic_w``; the static term (``idle_w × phi``) is
# per-step, kept separate from the per-op dynamic terms.
# ---------------------------------------------------------------------------


def energy_terms(flops, hbm_bytes, phi_s, device, collective_bytes=0.0
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(static_j, compute_j, memory_j, collective_j) per workload row.

    ``static_j = idle_w × phi_s`` (whatever the step's wall time is —
    measured or predicted); the dynamic terms are the roofline busy
    seconds × ``dynamic_w``.  A zero-watt envelope returns all zeros."""
    dyn = device.dynamic_w
    static_j = device.idle_w * np.asarray(phi_s, dtype=np.float64)
    compute_s, memory_s, coll_s = lm_roofline_terms(
        flops, hbm_bytes, collective_bytes, device)
    return static_j, dyn * compute_s, dyn * memory_s, dyn * coll_s


def watts_proxy(flops, phi_s, device) -> np.ndarray:
    """Modelled average board draw of a measured step: idle plus the
    dynamic range scaled by compute-roofline utilisation (busy seconds /
    measured wall seconds, clamped to 1).  Calibration uses it as the
    energy ground-truth proxy when no power rail was sampled."""
    compute_s = np.asarray(flops, dtype=np.float64) / device.peak_flops
    phi = np.asarray(phi_s, dtype=np.float64)
    util = np.where(phi > 0.0,
                    np.minimum(1.0, compute_s / np.maximum(phi, 1e-300)),
                    0.0)
    return device.idle_w + device.dynamic_w * util


def price_ledger_energy(ledger: CostLedger, device) -> CostLedger:
    """A copy of ``ledger`` with every record's dynamic energy stamped:
    ``energy_j = flops·(dyn/peak) + hbm·(dyn/bw) + coll·(dyn/ici)``.

    Parity contract (same as flops/bytes): the per-class energy sums of
    the returned ledger re-sum to its aggregate ``energy_j`` —
    bit-identically when the envelope constants are powers of two,
    within 1e-9 relative otherwise."""
    dyn = device.dynamic_w
    kf = dyn / device.peak_flops
    kb = dyn / device.hbm_bw
    kc = dyn / device.ici_bw
    return CostLedger([
        replace(r, energy_j=(r.flops * kf + r.hbm_bytes * kb
                             + r.collective_bytes * kc))
        for r in ledger
    ])


def cnn_energy_class_joules(feats: np.ndarray, bytes_per_el: int, device
                            ) -> dict[str, np.ndarray]:
    """Per-class dynamic energy of a CNN training step, keyed by op class
    (``matmul``/``elementwise``/``data_movement``).  The values sum to the
    aggregate dynamic energy of :func:`energy_terms` because the underlying
    latency class columns sum to the aggregate terms."""
    cols = latency_class_columns(feats, bytes_per_el)
    kf = device.dynamic_w / device.peak_flops
    kb = device.dynamic_w / device.hbm_bw
    return {
        "matmul": cols["flops_matmul"] * kf,
        "elementwise": cols["hbm_elementwise"] * kb,
        "data_movement": cols["hbm_data_movement"] * kb,
    }


# ---------------------------------------------------------------------------
# Class-wise columns.  The class-wise NNLS fit (engine/calibrate.calibrate)
# solves for one coefficient per column below, and the class-wise
# prediction paths multiply the SAME columns by the fitted
# ``DeviceSpec.class_coeffs``.  Two invariants:
#
#   sum over flops columns  == the aggregate flops term
#   sum over byte columns   == the aggregate bytes_moved term
#
# so the aggregate fit is exactly the class-wise fit with tied
# coefficients, and a class-wise solution can never *lose* information.
# ---------------------------------------------------------------------------

# CNN (Appendix-B feature) decomposition: all MACs are conv-lowered matmul
# work; traffic splits into the allocation families (elementwise streaming)
# and the im2col lowering volume (pure data movement).
CNN_LATENCY_COLUMNS: tuple[str, ...] = (
    "flops_matmul", "hbm_elementwise", "hbm_data_movement",
)


def latency_class_columns(feats: np.ndarray, bytes_per_el: int
                          ) -> dict[str, np.ndarray]:
    """Per-class latency regressor columns (``CNN_LATENCY_COLUMNS`` order)
    for training-step workloads.  ``flops_matmul`` equals the aggregate
    flops term; the two byte columns sum to the aggregate bytes_moved."""
    F = np.atleast_2d(np.asarray(feats, dtype=np.float64))
    return {
        "flops_matmul": 2.0 * F[:, _I_OPS],
        "hbm_elementwise": float(bytes_per_el) * F[:, _I_ALLOC],
        "hbm_data_movement": float(bytes_per_el) * F[:, _I_I2C],
    }


# LM (cost ledger) decomposition: one flops + one bytes column per op class,
# plus the total collective traffic.
LM_LATENCY_COLUMNS: tuple[str, ...] = tuple(
    [f"flops_{cls}" for cls in OP_CLASSES]
    + [f"hbm_{cls}" for cls in OP_CLASSES]
    + ["collective"]
)


def ledger_latency_columns(class_sums) -> dict[str, np.ndarray]:
    """(``LM_LATENCY_COLUMNS`` name → per-row array) from per-row class
    sums: one entry per workload row, either a :class:`CostLedger` or a
    ``{op_class: {"flops", "hbm_bytes", "collective_bytes"}}`` dict (a
    ledger's ``class_sums()``, as campaign records persist it under
    ``cost_classes``; ``None`` is an empty row)."""
    sums = [cs.class_sums() if isinstance(cs, CostLedger) else (cs or {})
            for cs in class_sums]
    cols: dict[str, np.ndarray] = {}
    for cls in OP_CLASSES:
        cols[f"flops_{cls}"] = np.array(
            [s.get(cls, {}).get("flops", 0.0) for s in sums], dtype=np.float64)
        cols[f"hbm_{cls}"] = np.array(
            [s.get(cls, {}).get("hbm_bytes", 0.0) for s in sums],
            dtype=np.float64)
    cols["collective"] = np.array(
        [sum(s.get(cls, {}).get("collective_bytes", 0.0) for cls in s)
         for s in sums], dtype=np.float64)
    return cols


def classwise_seconds(columns: dict, coeffs: dict) -> np.ndarray:
    """Seconds under class-wise fitted constants: the coefficients'
    ``_intercept`` plus Σ coeff × column over the shared column names.
    Columns absent from ``coeffs`` (classes the fit zeroed or never saw)
    contribute nothing — exactly how the NNLS treated them."""
    total = np.asarray(float(coeffs.get("_intercept", 0.0)), dtype=np.float64)
    for name, col in columns.items():
        c = coeffs.get(name, 0.0)
        if c:
            total = total + c * np.asarray(col, dtype=np.float64)
    return total


def collective_seconds(collective_bytes, device) -> np.ndarray:
    """Seconds a device spends moving ``collective_bytes`` of collective
    traffic.  A campaign-fitted coefficient
    (``class_coeffs["lm_latency"]["collective"]``) prices the bytes when
    the device carries one; otherwise the roofline denominator ``ici_bw``
    does."""
    b = np.asarray(collective_bytes, dtype=np.float64)
    coeffs = device.class_coeffs.get("lm_latency") or {}
    c = float(coeffs.get("collective", 0.0))
    if c > 0.0:
        return c * b
    return b / device.ici_bw


def memory_terms(feats: np.ndarray, bytes_per_el: int) -> tuple[np.ndarray, np.ndarray]:
    """(weight_bytes, activation_bytes) per training-step workload — the
    two allocation families whose per-device scales the memory fit solves
    for (weights scale with optimizer/grad copies, activations with batch)."""
    F = np.atleast_2d(np.asarray(feats, dtype=np.float64))
    weight_bytes = bytes_per_el * F[:, _I_W]
    act_bytes = bytes_per_el * (F[:, _I_IFM] + F[:, _I_OFM])
    return weight_bytes, act_bytes
