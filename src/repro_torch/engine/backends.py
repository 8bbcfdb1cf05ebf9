"""CostBackend implementations (port of ``repro/engine/backends.py``).

Three ways to answer the same question, in decreasing accuracy and
increasing speed of setup:

* :class:`ProfilerBackend`   — ground truth: run the real step on the card.
* :class:`AnalyticalBackend` — no fitting, no execution: the Appendix-B
  closed forms for CNNs, priced by a :class:`DeviceSpec`.
* :class:`ForestBackend`     — the fitted perf4sight predictor; microseconds
  per query once fitted, fully batched.

:class:`EnsembleBackend` chains them (forest → analytical → profiler by
convention): each query is answered by the first backend in the chain that
supports it and succeeds, so a search job transparently degrades from
"fitted forest" to "analytical" to "measure it" instead of crashing.

The forest, analytical and ensemble paths are numpy only and held exactly
against the reference, cache salts included.  What the port does not have
yet: LM arch queries.  The reference's forest answers them with a
campaign-fitted ``LMForest`` (ROADMAP queue 1 item 6) and its analytical
backend by compiling the step with ``jax.jit`` and pricing the HLO, which
in the port needs the aten-op cost ledger of item 5b; the analytical
backend raises :class:`BackendUnavailable` for them, so an ensemble falls
through to the next link.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.features import FEATURE_NAMES, feature_matrix
from repro_torch.core.predictor import Perf4Sight
from repro_torch.device import resolve_device as resolve_torch_device
from repro_torch.engine.decompose import (
    classwise_seconds,
    cnn_energy_class_joules,
    energy_terms,
    latency_class_columns,
    latency_terms,
    memory_terms,
)
from repro_torch.engine.devices import DeviceSpec, resolve_device
from repro_torch.engine.types import (
    STAGE_INFER,
    STAGE_TRAIN,
    BackendUnavailable,
    CostEstimate,
    CostQuery,
)

__all__ = [
    "ForestBackend",
    "AnalyticalBackend",
    "ProfilerBackend",
    "EnsembleBackend",
]

LM_FOREST_TODO = ("LM arch queries through a campaign-fitted LMForest are not "
                  "ported yet (ROADMAP.md, Queue 1 item 6: 'campaign/')")
LM_ANALYTICAL_TODO = ("analytical LM arch queries need the port's cost-ledger "
                      "producer (ROADMAP.md, Queue 1 item 5b)")

# CNN energy-fit column → ledger op class, for the per-class breakdown the
# fitted path reports (the columns are already class-labelled).
_CNN_COL2CLS = {"flops_matmul": "matmul", "hbm_elementwise": "elementwise",
                "hbm_data_movement": "data_movement"}


class ForestBackend:
    """Batched prediction through fitted :class:`Perf4Sight` models (one per
    stage) for CNN conv-spec queries.  N queries cost one feature-matrix
    build + one packed forest traversal per attribute and nothing on the
    card — the engine's hot path."""

    name = "forest"

    def __init__(self, train: Perf4Sight | None = None,
                 infer: Perf4Sight | None = None, lm=None):
        if lm is not None:
            raise NotImplementedError(LM_FOREST_TODO)
        self.predictors = {STAGE_TRAIN: train, STAGE_INFER: infer}

    def _predictor(self, stage: str) -> Perf4Sight | None:
        p = self.predictors.get(stage)
        return p if (p is not None and p.fitted) else None

    def cache_salt(self) -> str:
        """Content hash of the fitted models: a refit predictor invalidates
        on-disk estimates instead of silently serving stale ones.  The last
        part is the reference's LM-forest slot, always empty here."""
        parts = []
        for stage in (STAGE_TRAIN, STAGE_INFER):
            p = self._predictor(stage)
            parts.append(p.content_hash() if p is not None else "-")
        parts.append("-")
        return f"{self.name}:" + ":".join(parts)

    def supports(self, query: CostQuery) -> bool:
        return query.spec is not None and self._predictor(query.stage) is not None

    def estimate(self, queries: list[CostQuery]) -> list[CostEstimate]:
        results: list[CostEstimate | None] = [None] * len(queries)
        by_stage: dict[str, list[int]] = {}
        for i, q in enumerate(queries):
            if not self.supports(q):
                raise BackendUnavailable(f"forest backend cannot answer {q}")
            by_stage.setdefault(q.stage, []).append(i)
        for stage, idx in by_stage.items():
            predictor = self._predictor(stage)
            g, p = predictor.predict_batch(
                [(queries[i].spec, queries[i].bs) for i in idx])
            for j, i in enumerate(idx):
                results[i] = CostEstimate(
                    gamma_mb=float(g[j]), phi_ms=float(p[j]), source=self.name)
        return results


class AnalyticalBackend:
    """No-fit estimates for CNN conv-spec queries, from the Appendix-B
    closed forms: Γ from the algorithm-independent tensor allocations, Φ
    from a roofline over the im2col op count and allocation traffic.

    Hardware constants come from :class:`~repro_torch.engine.devices.DeviceSpec`
    (``device``) — registry guesses by default, per-device fitted constants
    after :func:`repro_torch.engine.calibrate.calibrate`.  ``lm_device`` and
    ``reduced`` configure the reference's LM path; the port keeps them in
    the cache salt, so salts agree with the reference's, and answers no
    arch query (module docstring).
    """

    name = "analytical"

    def __init__(self, device: "DeviceSpec | str | dict | None" = None,
                 lm_device: "DeviceSpec | str | dict | None" = None,
                 reduced: bool = True, bytes_per_el: int = 4):
        # ``device`` / ``lm_device`` take registry names, persisted spec
        # paths, dicts of overrides or DeviceSpec instances (engine/devices.py)
        self.device = resolve_device(device)
        self.lm_device = resolve_device(lm_device, default="tpu_v5e")
        self.reduced = reduced
        self.bytes_per_el = bytes_per_el
        # infer-stage heuristic indices; the train stage goes through the
        # shared engine/decompose.py terms instead
        self._i_alloc = FEATURE_NAMES.index("mem_alloc_total")
        self._i_ops_fwd = FEATURE_NAMES.index("mm_ops_fwd")
        self._i_i2c = FEATURE_NAMES.index("mm_i2c_total_sum")

    def cache_salt(self) -> str:
        # Salted by BOTH device fingerprints: calibrated and uncalibrated
        # estimates (or two differently-fitted specs) never alias on disk.
        return (f"{self.name}:{self.reduced}:{self.bytes_per_el}:"
                f"{self.device.fingerprint()}:{self.lm_device.fingerprint()}")

    def supports(self, query: CostQuery) -> bool:
        return query.spec is not None or query.arch is not None

    def estimate(self, queries: list[CostQuery]) -> list[CostEstimate]:
        if any(q.spec is None and q.arch is not None for q in queries):
            raise BackendUnavailable(LM_ANALYTICAL_TODO)
        if any(q.spec is None for q in queries):
            raise BackendUnavailable("analytical backend cannot answer model-only queries")
        if not queries:
            return []
        X = feature_matrix([(q.spec, q.bs) for q in queries])
        return [self._estimate_spec(q, X[j]) for j, q in enumerate(queries)]

    def _estimate_spec(self, q: CostQuery, feats: np.ndarray) -> CostEstimate:
        # Γ: element count of weights/grads/activation-grads (App. B.2.1).
        # Inference allocates no gradient buffers: approximate with the
        # weight + activation terms only (~alloc_total minus the grad terms
        # isn't directly a feature, so scale by the fwd/total op ratio).
        dev = self.device
        if q.stage == STAGE_INFER:
            # Inference heuristic: drop bwd_w / bwd_x buffers and ops.
            alloc = feats[self._i_alloc] / 3.0
            ops = feats[self._i_ops_fwd]
            i2c = feats[self._i_i2c] / 3.0
            flops = 2.0 * ops
            bytes_moved = self.bytes_per_el * (alloc + i2c)
            gamma_mb = dev.round_alloc(self.bytes_per_el * alloc) / 1e6
        else:
            # Train stage: the SAME decomposition the calibration fit uses
            # (engine/decompose.py) — fitted constants multiply these terms.
            flops, bytes_moved = (v[0] for v in
                                  latency_terms(feats, self.bytes_per_el))
            if dev.calibrated:
                w_b, a_b = (v[0] for v in
                            memory_terms(feats, self.bytes_per_el))
                gamma_mb = (dev.mem_base_mb
                            + dev.mem_weight_scale * dev.round_alloc(w_b) / 1e6
                            + dev.mem_act_scale * dev.round_alloc(a_b) / 1e6)
            else:
                gamma_mb = dev.round_alloc(
                    self.bytes_per_el * feats[self._i_alloc]) / 1e6
        compute_s = flops / dev.peak_flops
        memory_s = bytes_moved / dev.hbm_bw
        coeffs = dev.class_coeffs.get("cnn_latency")
        if dev.calibrated and q.stage != STAGE_TRAIN:
            # The additive combine and launch overhead were fitted on FULL
            # training steps (backward-pass dispatch included); applying
            # them to inference would let the train-fitted intercept
            # dominate small sub-millisecond candidates.  Inference reuses
            # only the fitted denominators under the plain roofline max.
            phi_ms = max(compute_s, memory_s) * 1e3
        elif dev.calibrated and coeffs:
            # Class-wise fitted constants: price the SAME decompose columns
            # the calibration solved over (single-source-of-truth contract).
            phi_ms = float(np.atleast_1d(classwise_seconds(
                latency_class_columns(feats, self.bytes_per_el),
                coeffs))[0]) * 1e3
        else:
            phi_ms = dev.combine_terms(compute_s, memory_s) * 1e3

        # Energy: fitted class-wise constants when calibration found them
        # (train stage — where they were fitted), the device power envelope
        # otherwise.  Either way the per-class breakdown re-sums to the
        # dynamic aggregate (the columns sum to the aggregate terms).
        cols = (latency_class_columns(feats, self.bytes_per_el)
                if q.stage == STAGE_TRAIN else None)
        e_coeffs = dev.class_coeffs.get("cnn_energy")
        energy_classes = None
        if dev.calibrated and e_coeffs and cols is not None:
            energy_j = float(np.atleast_1d(
                classwise_seconds(cols, e_coeffs))[0])
            energy_fit = "fitted"
            energy_classes = {
                _CNN_COL2CLS[name]: float(e_coeffs.get(name, 0.0)
                                          * np.atleast_1d(col)[0])
                for name, col in cols.items()}
        else:
            static_j, comp_j, mem_j, _ = energy_terms(
                flops, bytes_moved, phi_ms / 1e3, dev)
            energy_j = float(np.atleast_1d(static_j + comp_j + mem_j)[0])
            energy_fit = "envelope"
            if cols is not None:
                energy_classes = {
                    k: float(np.atleast_1d(v)[0]) for k, v in
                    cnn_energy_class_joules(feats, self.bytes_per_el,
                                            dev).items()}

        detail = {"compute_s": float(compute_s), "memory_s": float(memory_s),
                  "device": dev.name, "calibrated": dev.calibrated,
                  "latency_fit": "classwise" if (dev.calibrated and coeffs
                                                 and q.stage == STAGE_TRAIN)
                  else "aggregate",
                  "energy_fit": energy_fit,
                  "dominant": "compute" if compute_s >= memory_s else "memory"}
        if energy_classes is not None:
            detail["energy_classes"] = energy_classes
        return CostEstimate(
            gamma_mb=float(gamma_mb), phi_ms=float(phi_ms),
            energy_j=energy_j, source=self.name, detail=detail)


class ProfilerBackend:
    """Ground truth: run the real training/inference step for a concrete
    built model on ``device`` (default the card; raises without CUDA
    unless ``device="cpu"``), through :mod:`repro_torch.core.profiler`.
    Inherently per-query (each candidate is its own model); used for
    calibration and as the last link of the ensemble chain.

    ``detail`` keeps the reference's keys: ``compile_s`` (the first call's
    seconds; nothing is compiled in the port), ``flops`` (matmul and
    convolution flops, counted on the meta device) and ``temp_mb``.  The
    cache salt adds the device type to the reference's, so a CPU
    measurement never answers for the card."""

    name = "profiler"

    def __init__(self, repeats: int = 2, warmup: int = 1, run: bool = True,
                 device="cuda"):
        self.repeats = repeats
        self.warmup = warmup
        self.run = run
        self.device = resolve_torch_device(device)

    def cache_salt(self) -> str:
        return f"{self.name}:{self.repeats}:{self.warmup}:{self.run}:{self.device.type}"

    def supports(self, query: CostQuery) -> bool:
        return query.model is not None

    def estimate(self, queries: list[CostQuery]) -> list[CostEstimate]:
        from repro_torch.core.profiler import profile_inference, profile_training

        out = []
        for q in queries:
            if q.model is None:
                raise BackendUnavailable("profiler backend needs a built model")
            prof = profile_training if q.stage == STAGE_TRAIN else profile_inference
            res = prof(q.model, q.bs, repeats=self.repeats, warmup=self.warmup,
                       run=self.run, device=self.device)
            out.append(CostEstimate(
                gamma_mb=res.gamma_mb, phi_ms=res.phi_ms, source=self.name,
                detail={"compile_s": res.compile_s, "flops": res.flops,
                        "temp_mb": res.temp_mb}))
        return out


class EnsembleBackend:
    """Fallback chain: each query is answered by the first backend that
    supports it and succeeds.  A backend failing with
    :class:`BackendUnavailable` drops out for that batch only; remaining
    queries flow to the next link."""

    name = "ensemble"

    def __init__(self, backends: list):
        if not backends:
            raise ValueError("empty backend chain")
        self.backends = list(backends)

    def cache_salt(self) -> str:
        salts = [getattr(b, "cache_salt", lambda: b.name)() for b in self.backends]
        return f"{self.name}:[" + "|".join(salts) + "]"

    def supports(self, query: CostQuery) -> bool:
        return any(b.supports(query) for b in self.backends)

    def estimate(self, queries: list[CostQuery]) -> list[CostEstimate]:
        results: list[CostEstimate | None] = [None] * len(queries)
        remaining = list(range(len(queries)))
        failures: list[str] = []
        last_exc: BackendUnavailable | None = None
        for backend in self.backends:
            if not remaining:
                break
            idx = [i for i in remaining if backend.supports(queries[i])]
            if not idx:
                continue
            try:
                ests = backend.estimate([queries[i] for i in idx])
            except BackendUnavailable as e:
                # One poisoned query must not discard the whole batch's
                # answerable queries: retry per query so only the failing
                # ones fall through.
                if len(idx) > 1:
                    salvaged = 0
                    for i in idx:
                        try:
                            results[i] = backend.estimate([queries[i]])[0]
                            salvaged += 1
                        except BackendUnavailable as e2:
                            last_exc = e2
                    if salvaged:
                        failures.append(
                            f"{backend.name}: answered {salvaged}/{len(idx)}"
                            f" after batch failure ({e})")
                    else:
                        failures.append(f"{backend.name}: {e}")
                else:
                    failures.append(f"{backend.name}: {e}")
                    last_exc = e
                remaining = [i for i in remaining if results[i] is None]
                continue
            for i, est in zip(idx, ests):
                results[i] = est
            remaining = [i for i in remaining if results[i] is None]
        if remaining:
            why = ("; ".join(failures)) if failures else "no backend supports them"
            raise BackendUnavailable(
                f"no backend in {[b.name for b in self.backends]} could answer "
                f"{len(remaining)}/{len(queries)} queries ({why})") from last_exc
        return results
