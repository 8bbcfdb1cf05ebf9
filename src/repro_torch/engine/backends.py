"""CostBackend implementations (port of ``repro/engine/backends.py``).

Three ways to answer the same question, in decreasing accuracy and
increasing speed of setup:

* :class:`ProfilerBackend`   — ground truth: run the real step on the card.
* :class:`AnalyticalBackend` — no fitting, no execution: the Appendix-B
  closed forms for CNNs, and for LM arch queries a roofline over the
  aten-op cost ledger of the step traced on meta tensors.
* :class:`ForestBackend`     — the fitted perf4sight predictor; microseconds
  per query once fitted, fully batched.

:class:`EnsembleBackend` chains them (forest → analytical → profiler by
convention): each query is answered by the first backend in the chain that
supports it and succeeds, so a search job transparently degrades from
"fitted forest" to "analytical" to "measure it" instead of crashing.

The forest, CNN analytical and ensemble paths are numpy only and held
exactly against the reference, cache salts included.  The LM analytical
path prices the same way as the reference's from its own ledger: the
reference compiles the step with ``jax.jit`` and parses XLA's HLO, the
port traces the eager step (``core/hlo_cost.trace_cost``); FLOPs agree,
bytes are eager's (unfused) and Γ is the written definition of a traced
step (``core/profiler.meta_memory``).  ``ForestBackend``'s LM branch
reads the campaign-fitted ``repro_torch.campaign.LMForest`` (any object
with ``fitted``, ``content_hash()``, ``predict_queries``,
``default_device``, ``meta`` and optional
``predict_energy``/``energy_fitted`` will do); ``campaign.fit
.register_lm_forest`` attaches one to an engine's chain.
"""

from __future__ import annotations

import time

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
    ledger_latency_columns,
    lm_roofline_terms,
    memory_terms,
    price_ledger_energy,
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

# CNN energy-fit column → ledger op class, for the per-class breakdown the
# fitted path reports (the columns are already class-labelled).
_CNN_COL2CLS = {"flops_matmul": "matmul", "hbm_elementwise": "elementwise",
                "hbm_data_movement": "data_movement"}


class ForestBackend:
    """Batched prediction through fitted forests: :class:`Perf4Sight` models
    (one per stage) for CNN conv-spec queries, and a fitted LM forest
    (module docstring) for LM arch queries.  N queries cost one
    feature-matrix build + one packed forest traversal per attribute and
    nothing on the card — the engine's hot path."""

    name = "forest"

    def __init__(self, train: Perf4Sight | None = None,
                 infer: Perf4Sight | None = None, lm=None):
        self.predictors = {STAGE_TRAIN: train, STAGE_INFER: infer}
        self.lm = lm

    def _predictor(self, stage: str) -> Perf4Sight | None:
        p = self.predictors.get(stage)
        return p if (p is not None and p.fitted) else None

    def _lm_forest(self):
        lm = self.lm
        return lm if (lm is not None and getattr(lm, "fitted", False)) else None

    def cache_salt(self) -> str:
        """Content hash of the fitted models: a refit predictor invalidates
        on-disk estimates instead of silently serving stale ones."""
        parts = []
        for stage in (STAGE_TRAIN, STAGE_INFER):
            p = self._predictor(stage)
            parts.append(p.content_hash() if p is not None else "-")
        lm = self._lm_forest()
        parts.append(lm.content_hash() if lm is not None else "-")
        return f"{self.name}:" + ":".join(parts)

    def supports(self, query: CostQuery) -> bool:
        if query.spec is not None:
            return self._predictor(query.stage) is not None
        return query.arch is not None and self._lm_forest() is not None

    def estimate(self, queries: list[CostQuery]) -> list[CostEstimate]:
        results: list[CostEstimate | None] = [None] * len(queries)
        by_stage: dict[str, list[int]] = {}
        lm_idx: list[int] = []
        for i, q in enumerate(queries):
            if not self.supports(q):
                raise BackendUnavailable(f"forest backend cannot answer {q}")
            if q.spec is not None:
                by_stage.setdefault(q.stage, []).append(i)
            else:
                lm_idx.append(i)
        for stage, idx in by_stage.items():
            predictor = self._predictor(stage)
            g, p = predictor.predict_batch(
                [(queries[i].spec, queries[i].bs) for i in idx])
            for j, i in enumerate(idx):
                results[i] = CostEstimate(
                    gamma_mb=float(g[j]), phi_ms=float(p[j]), source=self.name)
        if lm_idx:
            lm = self._lm_forest()
            lm_queries = [queries[i] for i in lm_idx]
            g, p = lm.predict_queries(lm_queries)
            # Energy is an optional forest attribute (forests fitted before
            # the energy column fit none) — getattr, as the reference reads it.
            e = None
            predict_energy = getattr(lm, "predict_energy", None)
            if callable(predict_energy) and getattr(lm, "energy_fitted", False):
                e = predict_energy(lm_queries)
            detail = {"lm": True, "device": lm.default_device.name,
                      "plan_hash": lm.meta.get("plan_hash")}
            for j, i in enumerate(lm_idx):
                results[i] = CostEstimate(
                    gamma_mb=float(g[j]), phi_ms=float(p[j]),
                    energy_j=float(e[j]) if e is not None else 0.0,
                    source=self.name, detail=dict(detail))
        return results


class AnalyticalBackend:
    """No-fit estimates.

    CNN conv-spec queries use the Appendix-B closed forms directly: Γ from
    the algorithm-independent tensor allocations, Φ from a roofline over the
    im2col op count and allocation traffic.  LM arch queries trace the real
    step on meta tensors (no allocation, no launch) and price its aten-op
    cost ledger through the roofline terms — the same machinery as
    ``core/roofline.py``:

    * ``stage="infer"``: ``transformer.prefill`` over ``max_len = seq +
      n_prefix``; ``stage="train"``: ``loss_fn``, the backward (remat
      recompute included) and ``apply_updates`` (AdamW, f32 ``m``/``v``),
      as the port's ``Trainer`` runs a step;
    * Γ is the traced step's (``core/profiler.meta_memory``) rounded by
      the device's allocation granularity; Φ the class-wise fitted
      ``lm_latency`` constants when the device has them, else the roofline
      envelope; energy the fitted ``lm_energy`` constants, else the idle
      term plus the ledger's per-op dynamic joules;
    * the trace runs inside ``kernels.autotune.untimed``: a tuning lookup
      for an unseen shape takes the model-ranked config, so an estimate
      times no kernel on the card;
    * ``_compiled_cache`` answers a repeated (arch, stage, bs, seq,
      reduced, device) with no new trace; ``traces`` and
      ``trace_seconds`` count the traces, and ``last_trace`` keeps the
      newest one's (query, ``HloCost``, Γ terms) for reports.

    Hardware constants come from :class:`~repro_torch.engine.devices.DeviceSpec`
    (``device`` for the CNN path, ``lm_device`` for the LM path) — registry
    guesses by default, per-device fitted constants after
    :func:`repro_torch.engine.calibrate.calibrate`.
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
        self._compiled_cache: dict[tuple, CostEstimate] = {}
        self.traces = 0
        self.trace_seconds = 0.0
        self.last_trace = None
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
        results: list[CostEstimate | None] = [None] * len(queries)
        spec_idx = [i for i, q in enumerate(queries) if q.spec is not None]
        arch_idx = [i for i, q in enumerate(queries)
                    if q.spec is None and q.arch is not None]
        if len(spec_idx) + len(arch_idx) != len(queries):
            raise BackendUnavailable("analytical backend cannot answer model-only queries")
        if spec_idx:
            X = feature_matrix([(queries[i].spec, queries[i].bs) for i in spec_idx])
            for j, i in enumerate(spec_idx):
                results[i] = self._estimate_spec(queries[i], X[j])
        for i in arch_idx:
            results[i] = self._estimate_arch(queries[i])
        return results

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


    # -- LM traced-ledger path -------------------------------------------------

    def _reduced(self, q: CostQuery) -> bool:
        """Per-query smoke/full choice; the backend flag is only a default."""
        return self.reduced if q.reduced is None else q.reduced

    def _estimate_arch(self, q: CostQuery) -> CostEstimate:
        key = (q.arch, q.stage, q.bs, q.seq, self._reduced(q),
               self.lm_device.fingerprint())
        if key in self._compiled_cache:
            return self._compiled_cache[key]
        try:
            est = self._trace_arch(q)
        except BackendUnavailable:
            raise
        except Exception as e:  # trace failure → fall through the chain
            raise BackendUnavailable(
                f"analytical trace failed for {q.arch}: {e}") from e
        self._compiled_cache[key] = est
        return est

    def _trace_step(self, q: CostQuery, cfg):
        """Trace one step of ``q`` on meta tensors: (HloCost, Γ terms)."""
        import torch

        from repro_torch.convert import tree_leaves
        from repro_torch.core.hlo_cost import recording
        from repro_torch.core.profiler import meta_memory
        from repro_torch.kernels.autotune import untimed
        from repro_torch.models import transformer as T
        from repro_torch.optim.optimizer import (
            OptimizerConfig,
            apply_updates,
            init_opt_state,
        )

        kind = "train" if q.stage == STAGE_TRAIN else "prefill"
        model = T.param_specs(cfg)
        params = dict(model.named_parameters())
        batch = T.input_specs(cfg, kind, batch_size=q.bs, seq_len=q.seq)["batch"]
        resident = list(params.values()) + [
            t for t in tree_leaves(batch) if isinstance(t, torch.Tensor)]
        if kind == "train":
            opt_cfg = OptimizerConfig()
            opt = init_opt_state(params, opt_cfg)
            resident += tree_leaves(opt)
            for p in params.values():
                p.requires_grad_(True)
                p.grad = torch.zeros_like(p)

            def step(model, batch, opt):       # the Trainer's step
                for p in params.values():
                    p.grad.zero_()
                loss, _ = T.loss_fn(model, batch, cfg)
                loss.backward()
                apply_updates(params, {n: p.grad for n, p in params.items()},
                              opt, opt_cfg)
                return loss.detach()

            args = (model, batch, opt)
            grad_bytes = sum(p.numel() * p.element_size() for p in params.values())
        else:
            max_len = q.seq + cfg.n_prefix

            def step(model, batch):
                return T.prefill(model, batch, cfg, max_len=max_len)

            args, grad_bytes = (model, batch), 0
        with untimed(), recording() as cost:
            mem = meta_memory(step, args, resident, grad_bytes=grad_bytes,
                              train=kind == "train")
        return cost, mem

    def _trace_arch(self, q: CostQuery) -> CostEstimate:
        from repro_torch.configs.registry import get_config

        dev = self.lm_device
        reduced = self._reduced(q)
        cfg = get_config(q.arch, reduced=reduced)
        t0 = time.perf_counter()
        cost, mem = self._trace_step(q, cfg)
        compile_s = time.perf_counter() - t0
        self.traces += 1
        self.trace_seconds += compile_s
        self.last_trace = (q, cost, mem)

        gamma_mb = dev.round_alloc(mem["arg"] + mem["out"] + mem["temp"]) / 1e6
        # Price per-op dynamic energy into the ledger before taking class
        # sums: the breakdown every consumer sees (cost_classes) then
        # carries an energy bucket whose class sums re-sum to the ledger
        # aggregate — the same parity contract as flops/bytes.
        eledger = price_ledger_energy(cost.ledger, dev)
        class_sums = eledger.class_sums()
        compute_s, memory_s, coll_s = (
            float(v) for v in lm_roofline_terms(
                cost.flops, cost.hbm_bytes, cost.collective_bytes, dev))
        coeffs = dev.class_coeffs.get("lm_latency")
        if coeffs:
            phi_ms = float(np.atleast_1d(classwise_seconds(
                ledger_latency_columns([class_sums]), coeffs))[0]) * 1e3
        else:
            phi_ms = dev.combine_terms(compute_s, memory_s, coll_s) * 1e3
        terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}

        # Energy: fitted constants when present, envelope pricing otherwise
        # (static idle term + the per-op dynamic joules above).
        e_coeffs = dev.class_coeffs.get("lm_energy")
        static_j = dev.idle_w * (phi_ms / 1e3)
        if e_coeffs:
            energy_j = float(np.atleast_1d(classwise_seconds(
                ledger_latency_columns([class_sums]), e_coeffs))[0])
            energy_fit = "fitted"
        else:
            energy_j = float(static_j + eledger.energy_j)
            energy_fit = "envelope"
        return CostEstimate(
            gamma_mb=float(gamma_mb), phi_ms=float(phi_ms),
            energy_j=energy_j, source=self.name,
            detail={"flops": cost.flops, "hbm_bytes": cost.hbm_bytes,
                    "collective_bytes": cost.collective_bytes,
                    "cost_classes": class_sums,
                    "latency_fit": "classwise" if coeffs else "aggregate",
                    "energy_fit": energy_fit,
                    "energy_static_j": float(static_j),
                    "energy_classes": {cls: s["energy_j"]
                                       for cls, s in class_sums.items()},
                    "dominant": max(terms, key=terms.get),
                    "device": dev.name,
                    "compile_s": compile_s, "reduced": reduced})


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
