"""Compile-free featurization of LM campaign cells (port of
``repro/campaign/lm_features.py``, whole).

perf4sight's CNN path featurizes a topology analytically (App. B) and lets
the forest learn the device/framework nonlinearity.  This module is the LM
analogue: every feature is a pure function of
``(ArchConfig × ShapeSpec × mesh × DeviceSpec)`` — architecture widths and
counts, workload token geometry, mesh split, and *device-scaled roofline
terms* built from the same :func:`repro_torch.engine.decompose.lm_roofline_terms`
denominators the analytical backend and the constant fit divide by.

Because the calibrated device constants enter as features (and scale the
roofline terms), one forest fitted over a multi-device campaign serves the
whole fleet: a query for a new device re-featurizes with that device's
constants instead of needing its own forest.

Numpy only: nothing here traces or touches a device — a fitted forest
answers admission queries with no trace, which is the entire point of the
campaign.
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeSpec, mesh_split
from repro_torch.configs.registry import get_config
from repro_torch.core.roofline import model_flops_for_cell
from repro_torch.costmodel import OP_CLASSES
from repro_torch.engine.decompose import lm_roofline_terms
from repro_torch.engine.devices import DeviceSpec, resolve_device

__all__ = [
    "LM_FEATURE_NAMES",
    "CLASS_FEATURE_NAMES",
    "class_histogram",
    "ledger_class_features",
    "cell_features",
    "feature_matrix",
    "query_cell",
]

_BYTES_PER_EL = {"bfloat16": 2, "float16": 2, "float32": 4}

# Per-op-class histogram features (the cost-ledger taxonomy): what share
# of a cell's compute and traffic each class carries.  ONE histogram
# function (:func:`class_histogram`) serves two providers — the analytic
# class decomposition below (query time: compile-free, the serving
# contract) and the measured ``cost_classes`` a v2 campaign record stores
# (:func:`ledger_class_features`, for fit-time diagnostics and breakdown
# reporting) — so the two can never disagree about what a feature means.
CLASS_FEATURE_NAMES: tuple[str, ...] = tuple(
    [f"flops_frac_{cls}" for cls in OP_CLASSES]
    + [f"hbm_frac_{cls}" for cls in OP_CLASSES]
)


def class_histogram(class_sums: dict) -> np.ndarray:
    """(``CLASS_FEATURE_NAMES`` order) normalized per-class shares of a
    ``CostLedger.class_sums()``-shaped dict.  All-zero totals yield zero
    fractions (a compile-only or analytic cell with no traffic modeled)."""
    flops_tot = sum(s.get("flops", 0.0) for s in class_sums.values())
    hbm_tot = sum(s.get("hbm_bytes", 0.0) for s in class_sums.values())
    vals = [
        (class_sums.get(cls, {}).get("flops", 0.0) / flops_tot)
        if flops_tot else 0.0
        for cls in OP_CLASSES
    ] + [
        (class_sums.get(cls, {}).get("hbm_bytes", 0.0) / hbm_tot)
        if hbm_tot else 0.0
        for cls in OP_CLASSES
    ]
    return np.asarray(vals, dtype=np.float64)


def ledger_class_features(record: dict) -> np.ndarray:
    """The measured-ledger histogram of one campaign record (empty/missing
    ``cost_classes`` → all zeros) — diagnostics and breakdown reporting,
    NOT the forest's serving features (those stay analytic so a query
    needs no measurement)."""
    return class_histogram(record.get("cost_classes") or {})

LM_FEATURE_NAMES: tuple[str, ...] = (
    # --- architecture ---
    "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
    "padded_vocab", "n_experts", "experts_per_token", "moe_d_ff",
    "ssm_state", "n_encoder_layers", "hybrid_period",
    "params_total", "params_active",
    "is_moe", "is_ssm", "is_hybrid", "is_encdec",
    # --- workload shape ---
    "seq_len", "global_batch", "tokens",
    "kind_train", "kind_prefill", "kind_decode",
    # --- mesh ---
    "n_devices", "n_data", "n_model",
    # --- analytic per-device compute/byte decomposition ---
    "model_flops_dev", "param_bytes_dev", "act_bytes_dev", "kv_bytes_dev",
    "opt_bytes_dev", "coll_bytes_dev", "arithmetic_intensity",
    # --- device-scaled roofline terms (decompose.lm_roofline_terms) ---
    "compute_s", "memory_s", "collective_s", "roofline_ms",
    # --- raw device constants (fleet transfer) ---
    "log_peak_flops", "log_hbm_bw", "log_ici_bw", "launch_overhead_ms",
    "device_calibrated", "idle_w", "peak_w",
    # --- per-op-class histogram (cost-ledger taxonomy, analytic provider) ---
) + CLASS_FEATURE_NAMES


def analytic_class_sums(
    model_flops_dev: float,
    param_bytes_dev: float,
    act_bytes_dev: float,
    kv_bytes_dev: float,
    opt_bytes_dev: float,
    coll_bytes_dev: float,
) -> dict:
    """Compile-free per-class decomposition of a cell, in the
    ``CostLedger.class_sums()`` shape: model FLOPs are matmul-class work
    streaming the weights, activations/optimizer state are elementwise
    traffic, KV-cache movement is data movement, collectives are
    collectives.  Deliberately coarse — the forest corrects it; its job is
    carrying the right *shares* across architectures."""
    return {
        "matmul": {"flops": model_flops_dev, "hbm_bytes": param_bytes_dev,
                   "collective_bytes": 0.0},
        "elementwise": {"flops": 0.0,
                        "hbm_bytes": act_bytes_dev + opt_bytes_dev,
                        "collective_bytes": 0.0},
        "data_movement": {"flops": 0.0, "hbm_bytes": kv_bytes_dev,
                          "collective_bytes": 0.0},
        "collective": {"flops": 0.0, "hbm_bytes": 0.0,
                       "collective_bytes": coll_bytes_dev},
    }


def cell_features(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh_dims: tuple[int, ...],
    device: DeviceSpec,
) -> np.ndarray:
    """One feature row (``LM_FEATURE_NAMES`` order) — numpy only."""
    n_dev, n_data, n_model = mesh_split(tuple(mesh_dims))
    bpe = _BYTES_PER_EL.get(cfg.dtype, 2)
    V = cfg.padded_vocab()
    params = cfg.param_count()
    active = cfg.param_count(active_only=True)
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch

    # Per-device analytic decomposition.  These are deliberately coarse —
    # the forest corrects them from profiled ground truth; their job is to
    # carry the right *scaling* (linear in tokens, 1/n_dev in splits).
    model_flops_dev = model_flops_for_cell(cfg, shape) / n_dev
    param_bytes_dev = bpe * params / max(n_model, 1)
    act_bytes_dev = bpe * (tokens / max(n_data, 1)) * cfg.d_model \
        * max(cfg.n_layers, 1)
    kv_bytes_dev = 0.0
    if shape.kind != "train":
        kv_len = shape.seq_len + cfg.n_prefix
        kv_bytes_dev = (
            2.0 * bpe * (shape.global_batch / max(n_data, 1)) * kv_len
            * max(cfg.n_kv_heads, 1) * cfg.head_dim_ * max(cfg.n_layers, 1)
            / max(n_model, 1))
    opt_bytes_dev = 0.0
    if shape.kind == "train":
        # grads (model dtype) + adamw m/v slots (f32) per device
        opt_bytes_dev = (bpe + 2 * 4) * params / max(n_model, 1)
    # ring-model gradient/activation exchange: zero on a single device
    coll_bytes_dev = (
        2.0 * bpe * params / n_dev * (n_dev - 1) / n_dev if n_dev > 1 else 0.0)

    bytes_moved = param_bytes_dev + act_bytes_dev + kv_bytes_dev + opt_bytes_dev
    compute_s, memory_s, coll_s = (
        float(v) for v in lm_roofline_terms(
            model_flops_dev, bytes_moved, coll_bytes_dev, device))
    roofline_ms = device.combine_terms(compute_s, memory_s, coll_s) * 1e3

    vals = (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
        cfg.d_ff, V, cfg.n_experts, cfg.experts_per_token, cfg.moe_d_ff_,
        cfg.ssm_state, cfg.n_encoder_layers, cfg.hybrid_period,
        params, active,
        float(cfg.is_moe), float(cfg.family == "ssm"),
        float(cfg.hybrid_period > 0), float(cfg.n_encoder_layers > 0),
        shape.seq_len, shape.global_batch, tokens,
        float(shape.kind == "train"), float(shape.kind == "prefill"),
        float(shape.kind == "decode"),
        n_dev, n_data, n_model,
        model_flops_dev, param_bytes_dev, act_bytes_dev, kv_bytes_dev,
        opt_bytes_dev, coll_bytes_dev,
        model_flops_dev / max(bytes_moved, 1.0),
        compute_s, memory_s, coll_s, roofline_ms,
        math.log10(device.peak_flops), math.log10(device.hbm_bw),
        math.log10(device.ici_bw), device.launch_overhead_s * 1e3,
        float(device.calibrated), device.idle_w, device.peak_w,
    )
    hist = class_histogram(analytic_class_sums(
        model_flops_dev, param_bytes_dev, act_bytes_dev, kv_bytes_dev,
        opt_bytes_dev, coll_bytes_dev))
    x = np.concatenate([np.asarray(vals, dtype=np.float64), hist])
    assert x.shape == (len(LM_FEATURE_NAMES),)
    return x


def query_cell(query, *, reduced_default: bool = True):
    """(cfg, shape) a :class:`~repro_torch.engine.types.CostQuery` LM-cell query
    describes — the bridge from the engine's query language to campaign
    coordinates.  ``stage`` maps train→train and infer→prefill (admission
    asks about whole forward passes, not single decode steps)."""
    if query.arch is None:
        raise ValueError("not an LM-cell query (no arch id)")
    reduced = reduced_default if query.reduced is None else query.reduced
    cfg = get_config(query.arch, reduced=reduced)
    kind = "train" if query.stage == "train" else "prefill"
    return cfg, ShapeSpec("query", query.seq, query.bs, kind)


def feature_matrix(
    records: list[dict],
    *,
    device: "DeviceSpec | str | None" = None,
    classes_from: str = "analytic",
) -> np.ndarray:
    """(N, F) matrix from campaign ledger records (see ``runner.py`` for the
    schema).  ``device`` overrides the per-record device name — used to
    re-featurize one campaign under another device's constants.

    ``classes_from`` picks the provider of the per-class histogram block:
    ``"analytic"`` (default — what a bare query can also compute, the
    serving contract) or ``"ledger"`` (each record's measured
    ``cost_classes`` breakdown, for fit-time diagnostics and feature-
    importance studies; records without one keep the analytic row)."""
    if classes_from not in ("analytic", "ledger"):
        raise ValueError(f"classes_from must be 'analytic' or 'ledger', "
                         f"got {classes_from!r}")
    from repro_torch.campaign.plan import CampaignCell, mesh_dims

    n_cls = len(CLASS_FEATURE_NAMES)
    rows = []
    for rec in records:
        cell = CampaignCell.from_dict(rec)
        cfg = get_config(cell.arch, reduced=cell.reduced)
        dev = resolve_device(device if device is not None else cell.device)
        row = cell_features(cfg, cell.shape, mesh_dims(cell.mesh), dev)
        if classes_from == "ledger" and rec.get("cost_classes"):
            row = row.copy()
            row[-n_cls:] = ledger_class_features(rec)
        rows.append(row)
    return np.stack(rows) if rows else np.zeros((0, len(LM_FEATURE_NAMES)))
