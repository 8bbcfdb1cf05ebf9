"""Fit a :class:`DeviceSpec` from profiler ground truth (paper §5/§6)
(port of ``repro/engine/calibrate.py``, numpy only: the same datapoints
give the reference's fitted spec, field by field).

perf4sight's accuracy claims rest on per-device fitting: the toolflow
profiles a small (network × batch) grid on the target device, then fits
the model to that ground truth.  This module is the analytical-model
analogue — instead of training a forest, it solves for the handful of
hardware constants the closed forms need:

    phi_s    = launch_overhead_s + flops / peak_flops + bytes / hbm_bw
    gamma_mb = mem_base_mb + mem_weight_scale * weight_mb
                           + mem_act_scale   * activation_mb

Both are linear in the unknowns (1/peak_flops, 1/hbm_bw, the scales), with
all coefficients physically nonnegative, so the fit is a nonnegative least
squares over the per-workload compute/byte decomposition that
``core/features`` already produces (``engine/decompose.py``).  The
additive latency form is the standard relaxation of the roofline ``max``;
the fitted spec records it via ``combine="sum"``.

Ground truth comes from :class:`~repro_torch.engine.backends.ProfilerBackend`
(training steps on the card), consulted through a
:class:`~repro_torch.core.dataset.DatasetCache` so repeated calibrations
reuse profiled datapoints — on the card, the grid that ``collect_grid``
already profiled — instead of re-running the steps.  Timed autotuner
winners come from the port's ``TuningCache.entries()``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from repro_torch.core.dataset import DatasetCache, Datapoint
from repro_torch.core.features import network_features
from repro_torch.engine.devices import DeviceSpec, resolve_device
from repro_torch.engine.types import STAGE_TRAIN, CostQuery

__all__ = [
    "CalibrationWorkload",
    "default_workloads",
    "measure_ground_truth",
    "nnls",
    "timed_tuning_rows",
    "calibrate",
    "evaluate_accuracy",
]

@dataclass(frozen=True)
class CalibrationWorkload:
    """One cell of the calibration grid — the same coordinates as a
    :class:`~repro_torch.core.dataset.Datapoint`, so profiled ground truth is
    shared with the data-collection caches (``DatasetCache`` files)."""

    family: str
    level: float
    bs: int
    strategy: str = "random"
    width_mult: float = 0.25
    input_hw: int = 16
    seed: int = 0

    @property
    def key(self) -> str:
        return (
            f"{self.family}|l={self.level:.2f}|s={self.strategy}|bs={self.bs}"
            f"|wm={self.width_mult}|hw={self.input_hw}|seed={self.seed}"
        )

    def build_model(self):
        from repro_torch.core.dataset import GridSpec, _build_pruned

        grid = GridSpec(self.family, (self.level,), self.strategy, (self.bs,),
                        self.width_mult, self.input_hw, self.seed)
        return _build_pruned(grid, self.level)


def default_workloads(
    families: tuple[str, ...] = ("squeezenet",),
    levels: tuple[float, ...] = (0.0, 0.30, 0.50),
    batch_sizes: tuple[int, ...] = (2, 8, 16, 32),
    **kw,
) -> list[CalibrationWorkload]:
    """Small (network × pruning level × batch) grid: a few topologies spanning
    the footprint range, each profiled across batch sizes, so both fits see
    variation in the batch-dependent and batch-independent terms."""
    return [
        CalibrationWorkload(family=f, level=l, bs=b, **kw)
        for f in families for l in levels for b in batch_sizes
    ]


def nnls(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Nonnegative least squares, numpy-only (tier-1 runs without scipy).

    Lawson–Hanson active-set method: variables enter the passive (free) set
    by largest positive gradient and can LEAVE it again on a blocking step,
    so the returned point satisfies the NNLS KKT conditions — a
    remove-only clamp can permanently drop a variable (e.g. zero out the
    launch-overhead intercept) and silently return a worse fit.  The
    calibration systems are tiny (≤4 columns); this converges in a handful
    of iterations.
    """
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = A.shape[1]
    # Column scaling: the columns span ~15 orders of magnitude (counts of
    # FLOPs vs a constant 1), so solve in normalized coordinates.
    scale = np.linalg.norm(A, axis=0)
    scale[scale == 0] = 1.0
    An = A / scale
    x = np.zeros(n)
    passive = np.zeros(n, dtype=bool)
    w = An.T @ b
    tol = 1e-12 * max(float(np.abs(w).max()), 1.0)
    for _ in range(3 * n + 10):
        if passive.all() or (w[~passive] <= tol).all():
            break
        free = np.flatnonzero(~passive)
        passive[free[np.argmax(w[free])]] = True
        while True:
            s = np.zeros(n)
            s[passive], *_ = np.linalg.lstsq(An[:, passive], b, rcond=None)
            if (s[passive] > 0).all():
                x = s
                break
            # blocking step: walk toward s until the first passive variable
            # hits zero, then release it back to the active set
            blocking = passive & (s <= 0)
            alpha = np.min(x[blocking] / (x[blocking] - s[blocking]))
            x = x + alpha * (s - x)
            passive &= x > tol
            x[~passive] = 0.0
            if not passive.any():
                break
        w = An.T @ (b - An @ x)
    return x / scale


def measure_ground_truth(profiler, workloads, cache: DatasetCache | None = None,
                         stage: str = STAGE_TRAIN) -> tuple[list[Datapoint], int]:
    """Ground truth per workload: cached datapoint when available, otherwise
    one ProfilerBackend run (written back to the cache).  Returns
    ``(datapoints, n_profiled_live)``.  Callers that also want to score a
    backend against the same grid (``evaluate_accuracy``) should measure
    once here and pass ``datapoints=`` to :func:`calibrate` rather than
    letting it re-measure."""
    dps: list[Datapoint] = []
    profiled = 0
    for w in workloads:
        dp = cache.get(w.key) if cache is not None else None
        if dp is None:
            model = w.build_model()
            est = profiler.estimate(
                [CostQuery(spec=model.conv_specs(), bs=w.bs, stage=stage,
                           model=model)])[0]
            dp = Datapoint(
                family=w.family, level=w.level, strategy=w.strategy, bs=w.bs,
                width_mult=w.width_mult, input_hw=w.input_hw, seed=w.seed,
                gamma_mb=est.gamma_mb, phi_ms=est.phi_ms,
                features=[float(v) for v in
                          network_features(model.conv_specs(), w.bs)],
            )
            profiled += 1
            if cache is not None:
                cache.put(dp)
                cache.flush()
        if not dp.features:
            dp.features = [float(v) for v in network_features(
                w.build_model().conv_specs(), w.bs)]
        dps.append(dp)
    return dps, profiled


def _decompose(dps: list[Datapoint], bytes_per_el: int):
    """Per-workload (flops, bytes_moved, weight_mb, act_mb) + measured
    targets — the regressors of the two NNLS systems, produced by the SAME
    ``engine/decompose.py`` terms the analytical prediction path multiplies
    the fitted constants against — plus the per-op-class latency columns
    (``decompose.latency_class_columns``) the class-wise fit refines the
    aggregate terms into."""
    from repro_torch.engine.decompose import (
        latency_class_columns,
        latency_terms,
        memory_terms,
    )

    F = np.array([dp.features for dp in dps], dtype=np.float64)
    flops, bytes_moved = latency_terms(F, bytes_per_el)
    weight_bytes, act_bytes = memory_terms(F, bytes_per_el)
    cols = latency_class_columns(F, bytes_per_el)
    phi_s = np.array([dp.phi_ms for dp in dps]) / 1e3
    gamma_mb = np.array([dp.gamma_mb for dp in dps])
    return (flops, bytes_moved, weight_bytes / 1e6, act_bytes / 1e6, phi_s,
            gamma_mb, cols)


def _mape(pred: np.ndarray, true: np.ndarray) -> float:
    return float(np.mean(np.abs(pred - true) / np.maximum(np.abs(true), 1e-12)))


def timed_tuning_rows(tuning_cache) -> tuple[np.ndarray, np.ndarray]:
    """Extra latency-fit rows from wall-clock-timed autotuner winners.

    Every ``source:"timed"`` :class:`~repro_torch.kernels.autotune.TuningCache`
    entry is a measured (kernel launch → seconds) datapoint the device paid
    for anyway during tuning; its tiling model rebuilds the (flops, bytes)
    decomposition from the stored launch shape, giving the NNLS system
    single-kernel rows alongside the whole-training-step workloads.  Those
    rows pin down the roofline denominators at a granularity the step-level
    grid can't (one kernel = one dominant term), which is why the tuner
    feeds its measurements back here instead of discarding them.

    Returns ``(A_rows, phi_s)`` with columns matching the latency system
    ``[1, flops, bytes_moved]``; empty arrays when the cache has no timed
    entries (the model-ranked path stores ``source:"model"``).
    """
    from repro_torch.kernels.autotune import get_tiling

    rows, phi = [], []
    for entry in tuning_cache.entries():
        if entry.get("source") != "timed" or not entry.get("measured_us"):
            continue
        shape = entry.get("shape")
        if not shape:
            continue  # pre-shape-stamping cache entry: nothing to rebuild
        try:
            cost = get_tiling(entry["kernel"]).cost(shape, entry["config"])
        except KeyError:
            continue  # tiling module no longer registered
        rows.append([1.0, cost.flops, cost.hbm_bytes])
        phi.append(entry["measured_us"] * 1e-6)
    if not rows:
        return np.zeros((0, 3)), np.zeros(0)
    return np.asarray(rows, dtype=np.float64), np.asarray(phi, dtype=np.float64)


def calibrate(
    backend,
    profiler,
    workloads: list[CalibrationWorkload],
    *,
    cache: DatasetCache | str | None = None,
    datapoints: list[Datapoint] | None = None,
    tuning_cache=None,
    name: str | None = None,
    apply: bool = True,
) -> DeviceSpec:
    """Fit the backend's device constants against profiler ground truth.

    Runs ``workloads`` through ``profiler`` (cache-first), solves the two
    NNLS systems over the per-workload compute/byte decomposition, and
    returns a ``calibrated=True`` :class:`DeviceSpec` seeded from the
    backend's current device (capacity/interconnect/granularity carry
    over).  Callers that already measured the grid (via
    :func:`measure_ground_truth`) pass it as ``datapoints`` and no
    re-measurement happens.  A ``tuning_cache``
    (:class:`~repro_torch.kernels.autotune.TuningCache`) contributes its
    wall-clock-timed autotuner winners as extra latency rows
    (:func:`timed_tuning_rows`).  With ``apply=True`` (default) the backend
    is switched to the fitted spec in place — its ``cache_salt()`` changes
    with it, so engine caches never serve pre-calibration estimates
    afterwards.
    """
    if len(datapoints if datapoints is not None else workloads) < 3:
        raise ValueError("calibration needs >= 3 workloads to fit 3 constants")
    if isinstance(cache, str):
        cache = DatasetCache(cache)
    base = resolve_device(getattr(backend, "device", None))
    bytes_per_el = getattr(backend, "bytes_per_el", 4)

    if datapoints is not None:
        dps, profiled = datapoints, 0
    else:
        dps, profiled = measure_ground_truth(profiler, workloads, cache,
                                             STAGE_TRAIN)
    flops, bytes_moved, weight_mb, act_mb, phi_s, gamma_mb, cols = _decompose(
        dps, bytes_per_el)

    from repro_torch.engine.decompose import CNN_LATENCY_COLUMNS

    # Latency, aggregate: phi = c0 + c1·flops + c2·bytes, c ≥ 0 — and the
    # class-wise refinement over the same workloads: one coefficient per
    # decompose.CNN_LATENCY_COLUMNS column.  The aggregate system is the
    # class-wise one with tied byte coefficients, so the class-wise fit can
    # only match or improve the training error; whichever achieves the
    # lower MAPE is applied (the aggregate fallback keeps old behaviour
    # when the split carries no signal).
    ones = np.ones_like(phi_s)
    A_lat = np.stack([ones, flops, bytes_moved], axis=1)
    A_cls = np.stack([ones] + [cols[n] for n in CNN_LATENCY_COLUMNS], axis=1)
    b_lat = phi_s
    n_timed = 0
    if tuning_cache is not None:
        A_timed, phi_timed = timed_tuning_rows(tuning_cache)
        n_timed = len(phi_timed)
        if n_timed:
            A_lat = np.concatenate([A_lat, A_timed])
            # Kernel launches are matmul-class compute streaming its
            # operands: flops → flops_matmul, bytes → hbm_elementwise.
            A_timed_cls = np.zeros((n_timed, A_cls.shape[1]))
            A_timed_cls[:, 0] = A_timed[:, 0]
            A_timed_cls[:, 1 + CNN_LATENCY_COLUMNS.index("flops_matmul")] = \
                A_timed[:, 1]
            A_timed_cls[:, 1 + CNN_LATENCY_COLUMNS.index("hbm_elementwise")] = \
                A_timed[:, 2]
            A_cls = np.concatenate([A_cls, A_timed_cls])
            b_lat = np.concatenate([b_lat, phi_timed])
    c = nnls(A_lat, b_lat)
    c_cls = nnls(A_cls, b_lat)
    n_work = len(phi_s)
    phi_mape_agg = _mape(A_lat[:n_work] @ c, phi_s)
    phi_mape_cls = _mape(A_cls[:n_work] @ c_cls, phi_s)
    use_classwise = phi_mape_cls <= phi_mape_agg
    class_coeffs = dict(base.class_coeffs)
    class_coeffs.pop("cnn_latency", None)
    if use_classwise:
        class_coeffs["cnn_latency"] = {
            "_intercept": float(c_cls[0]),
            **{n: float(v) for n, v in zip(CNN_LATENCY_COLUMNS, c_cls[1:])},
        }
    # A zero coefficient means that term never binds on this grid; keep the
    # term inert with an effectively-infinite (but finite, serializable)
    # denominator instead of dividing by zero.  The classic fields always
    # carry the aggregate fit — anything reading peak_flops/hbm_bw sees a
    # self-consistent 3-term model; the class-wise refinement rides in
    # ``class_coeffs`` and is consumed only by the class-aware paths.
    peak_flops = 1.0 / c[1] if c[1] > 0 else 1e18
    hbm_bw = 1.0 / c[2] if c[2] > 0 else 1e18

    # Memory: gamma = m0 + m1·weight_mb + m2·act_mb, m ≥ 0.
    m = nnls(np.stack([ones, weight_mb, act_mb], axis=1), gamma_mb)

    # Energy: fitted exactly like latency — aggregate AND class-wise NNLS
    # over the same decompose columns, lower MAPE applied.  Ground truth
    # per workload is the datapoint's measured joules when a power rail
    # was sampled, else the base envelope's watts-proxy at the MEASURED
    # phi (decompose.watts_proxy).  A zero-watt base envelope yields
    # all-zero targets and the energy fit is skipped (energy_fit="none").
    # Either winning fit is stored over the class-column names (the
    # aggregate's tied byte coefficient mapped onto both byte columns) so
    # pricing stays one code path: classwise_seconds(·, "cnn_energy").
    from repro_torch.engine.decompose import watts_proxy

    energy_true = np.array([getattr(dp, "energy_j", 0.0) or 0.0 for dp in dps],
                           dtype=np.float64)
    proxied = energy_true <= 0
    if proxied.any():
        energy_true = np.where(
            proxied, watts_proxy(flops, phi_s, base) * phi_s, energy_true)
    class_coeffs.pop("cnn_energy", None)
    energy_meta: dict = {"energy_fit": "none"}
    if np.any(energy_true > 0):
        # Timed tuning rows carry no energy measurement: fit on the
        # workload rows only.
        e = nnls(A_lat[:n_work], energy_true)
        e_cls = nnls(A_cls[:n_work], energy_true)
        e_mape_agg = _mape(A_lat[:n_work] @ e, energy_true)
        e_mape_cls = _mape(A_cls[:n_work] @ e_cls, energy_true)
        use_classwise_e = e_mape_cls <= e_mape_agg
        if use_classwise_e:
            class_coeffs["cnn_energy"] = {
                "_intercept": float(e_cls[0]),
                **{n: float(v) for n, v in zip(CNN_LATENCY_COLUMNS,
                                               e_cls[1:])},
            }
        else:
            class_coeffs["cnn_energy"] = {
                "_intercept": float(e[0]),
                "flops_matmul": float(e[1]),
                "hbm_elementwise": float(e[2]),
                "hbm_data_movement": float(e[2]),
            }
        energy_meta = {
            "energy_fit": "classwise" if use_classwise_e else "aggregate",
            "energy_mape": min(e_mape_cls, e_mape_agg),
            "energy_mape_aggregate": e_mape_agg,
            "energy_mape_classwise": e_mape_cls,
            "energy_proxied": int(proxied.sum()),
        }

    spec = replace(
        base,
        name=name or f"{base.name}_calibrated",
        peak_flops=peak_flops,
        hbm_bw=hbm_bw,
        launch_overhead_s=float(c[0]),
        mem_base_mb=float(m[0]),
        mem_weight_scale=float(m[1]),
        mem_act_scale=float(m[2]),
        combine="sum",
        calibrated=True,
        class_coeffs=class_coeffs,
        meta={
            "base_device": base.name,
            "n_workloads": len(dps),
            "n_profiled": profiled,
            "n_timed_kernel_rows": n_timed,
            "latency_fit": "classwise" if use_classwise else "aggregate",
            "phi_mape": min(phi_mape_cls, phi_mape_agg),
            "phi_mape_aggregate": phi_mape_agg,
            "phi_mape_classwise": phi_mape_cls,
            "gamma_mape": _mape(m[0] + m[1] * weight_mb + m[2] * act_mb,
                                gamma_mb),
            **energy_meta,
        },
    )
    if apply:
        backend.device = spec
    return spec


def evaluate_accuracy(backend, dps: list[Datapoint]) -> dict:
    """Prediction error of ``backend`` against measured datapoints: MAPE of
    Φ (latency) and Γ (memory) — the paper's Table-4 framing."""
    ests = backend.estimate([
        CostQuery(spec=_spec_of(dp), bs=dp.bs, stage=STAGE_TRAIN)
        for dp in dps
    ])
    phi_pred = np.array([e.phi_ms for e in ests])
    gamma_pred = np.array([e.gamma_mb for e in ests])
    phi_true = np.array([dp.phi_ms for dp in dps])
    gamma_true = np.array([dp.gamma_mb for dp in dps])
    return {
        "phi_mape": _mape(phi_pred, phi_true),
        "gamma_mape": _mape(gamma_pred, gamma_true),
        "n": len(dps),
    }


def _spec_of(dp: Datapoint):
    """Rebuild the NetworkSpec for a datapoint's grid coordinates."""
    w = CalibrationWorkload(family=dp.family, level=dp.level, bs=dp.bs,
                            strategy=dp.strategy, width_mult=dp.width_mult,
                            input_hw=dp.input_hw, seed=dp.seed)
    return w.build_model().conv_specs()
