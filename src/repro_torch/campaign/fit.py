"""Fit campaign ledgers into serveable artifacts (port of
``repro/campaign/fit.py``, whole; artifacts load across the two
packages both ways).

Two fits come out of one ledger:

* :func:`fit_lm_forest` — an :class:`LMForest` (one hybrid ridge+forest per
  attribute, the same ``core/forest`` machinery as the CNN predictor) over
  the compile-free ``lm_features`` rows.  Registered with
  :class:`~repro_torch.engine.backends.ForestBackend`, it answers LM-cell
  ``CostQuery``s in microseconds with **no trace and nothing on the
  card** — the paper's "fit once, predict forever" loop closed for the LM
  workloads.
* :func:`fit_hlo_constants` — NNLS of the cost-ledger roofline terms
  (``core/hlo_cost.trace_cost`` in the port): solves for effective
  peak FLOP/s, HBM bandwidth, ICI bandwidth and launch overhead from the
  same ledger, returning a ``calibrated=True`` DeviceSpec for the
  analytical backend's LM path.

Both artifacts persist atomically (``core/fileio``) — NPZ for the packed
forest arrays, JSON for metadata/constants — and carry the plan hash +
device fingerprint they were fitted from.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import replace

import numpy as np

from repro_torch.campaign.lm_features import (
    LM_FEATURE_NAMES,
    cell_features,
    feature_matrix,
    query_cell,
)
from repro_torch.campaign.plan import mesh_dims
from repro_torch.core.fileio import atomic_write_bytes, atomic_write_json
from repro_torch.core.predictor import HybridRegressor, mape
from repro_torch.engine.calibrate import nnls
from repro_torch.engine.decompose import (
    classwise_seconds,
    ledger_latency_columns,
    lm_roofline_terms,
)
from repro_torch.engine.devices import DeviceSpec, resolve_device

__all__ = [
    "LMForest",
    "split_records",
    "check_device_fingerprints",
    "fit_lm_forest",
    "fit_hlo_constants",
    "register_lm_forest",
]


class LMForest:
    """Campaign-fitted (Γ, Φ) predictor for LM cells.

    Prediction is numpy-only: features come from ``lm_features`` (no
    trace), the regressors are the repo's own ridge+forest hybrids.
    ``meta`` records provenance (plan hash, device, mesh, holdout MAPEs);
    ``default_device``/``default_mesh`` fill in the coordinates a bare
    ``CostQuery`` doesn't carry."""

    def __init__(self, *, n_estimators: int = 60, min_samples_leaf: int = 1,
                 seed: int = 0):
        kw = dict(n_estimators=n_estimators,
                  min_samples_leaf=min_samples_leaf, max_features="third")
        self.gamma_model = HybridRegressor(seed=seed, **kw)
        self.phi_model = HybridRegressor(seed=seed + 1, **kw)
        # Energy is optional: only campaigns whose ledgers carry the v3
        # watts-proxy column grow it; ``energy_fitted`` gates prediction
        # (and persistence) so pre-energy artifacts stay loadable.
        self.energy_model = HybridRegressor(seed=seed + 2, **kw)
        self.energy_fitted = False
        self.meta: dict = {}
        self.fitted = False

    # -- coordinates -------------------------------------------------------

    @property
    def default_device(self) -> DeviceSpec:
        d = self.meta.get("device_spec")
        return DeviceSpec.from_dict(d) if d else resolve_device(
            self.meta.get("device", "host_cpu"))

    @property
    def default_mesh(self) -> tuple[int, ...]:
        return tuple(self.meta.get("mesh_dims", (1, 1)))

    # -- prediction --------------------------------------------------------

    def predict_features(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        return self.gamma_model.predict(X), self.phi_model.predict(X)

    def predict_queries(self, queries, *, device: DeviceSpec | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Batched (Γ MB, Φ ms) for engine ``CostQuery``s — one feature
        build + one packed traversal per attribute, no trace."""
        dev = device or self.default_device
        mesh = self.default_mesh
        reduced_default = bool(self.meta.get("reduced", True))
        X = np.stack([
            cell_features(*query_cell(q, reduced_default=reduced_default),
                          mesh, dev)
            for q in queries
        ])
        return self.predict_features(X)

    def predict_energy(self, queries, *, device: DeviceSpec | None = None
                       ) -> np.ndarray:
        """Batched per-step energy (J) for engine ``CostQuery``s — zeros
        when the fitting campaign carried no energy column."""
        dev = device or self.default_device
        mesh = self.default_mesh
        reduced_default = bool(self.meta.get("reduced", True))
        if not self.energy_fitted:
            return np.zeros(len(list(queries)), dtype=np.float64)
        X = np.stack([
            cell_features(*query_cell(q, reduced_default=reduced_default),
                          mesh, dev)
            for q in queries
        ])
        return self.energy_model.predict(np.atleast_2d(X))

    # -- identity / persistence -------------------------------------------

    def content_hash(self) -> str:
        h = hashlib.sha1()
        h.update(self.gamma_model.content_hash().encode())
        h.update(self.phi_model.content_hash().encode())
        if self.energy_fitted:  # pre-energy forests keep their old hash
            h.update(self.energy_model.content_hash().encode())
        h.update(json.dumps(self.meta.get("device_spec", {}),
                            sort_keys=True, default=str).encode())
        return h.hexdigest()

    def save(self, path: str) -> None:
        """Atomic persist; ``.npz`` packs the forest arrays (compact),
        ``.json`` keeps the nested dicts (inspectable).  Metadata rides in
        both."""
        if path.endswith(".npz"):
            arrays: dict[str, np.ndarray] = {}
            models = [("gamma_", self.gamma_model), ("phi_", self.phi_model)]
            if self.energy_fitted:
                models.append(("energy_", self.energy_model))
            for prefix, model in models:
                arrays.update(model.to_arrays(prefix))
            meta = json.dumps({"meta": self.meta,
                               "energy_fitted": self.energy_fitted,
                               "feature_names": list(LM_FEATURE_NAMES)})
            arrays["campaign_meta"] = np.frombuffer(meta.encode(), dtype=np.uint8)
            atomic_write_bytes(path, lambda f: np.savez_compressed(f, **arrays),
                               suffix=".npz")
            return
        blob = {
            "meta": self.meta, "feature_names": list(LM_FEATURE_NAMES),
            "energy_fitted": self.energy_fitted,
            "gamma": self.gamma_model.to_dict(),
            "phi": self.phi_model.to_dict(),
        }
        if self.energy_fitted:
            blob["energy"] = self.energy_model.to_dict()
        atomic_write_json(path, blob)

    @classmethod
    def load(cls, path: str) -> "LMForest":
        self = cls()
        if path.endswith(".npz"):
            with np.load(path) as arrays:
                header = json.loads(
                    bytes(arrays["campaign_meta"].tobytes()).decode())
                self.gamma_model = HybridRegressor.from_arrays(arrays, "gamma_")
                self.phi_model = HybridRegressor.from_arrays(arrays, "phi_")
                # Tolerant of pre-energy artifacts: the flag (and arrays)
                # only exist when the fitting ledger carried energy.
                if header.get("energy_fitted"):
                    self.energy_model = HybridRegressor.from_arrays(
                        arrays, "energy_")
                    self.energy_fitted = True
        else:
            with open(path) as f:
                blob = json.load(f)
            header = blob
            self.gamma_model = HybridRegressor.from_dict(blob["gamma"])
            self.phi_model = HybridRegressor.from_dict(blob["phi"])
            if blob.get("energy_fitted") and "energy" in blob:
                self.energy_model = HybridRegressor.from_dict(blob["energy"])
                self.energy_fitted = True
        names = header.get("feature_names", [])
        if names and list(names) != list(LM_FEATURE_NAMES):
            raise ValueError(
                f"{path} was fitted on a different feature set "
                f"({len(names)} features vs {len(LM_FEATURE_NAMES)}); refit "
                "the campaign with `python -m repro_torch.campaign fit`")
        self.meta = header.get("meta", {})
        self.fitted = True
        return self


def _ok_records(records) -> list[dict]:
    recs = [r for r in records if r.get("status") == "ok"]
    if not recs:
        raise ValueError("no status:'ok' records in the ledger — run the "
                         "campaign first (python -m repro_torch.campaign run)")
    return recs


def check_device_fingerprints(records, *, device=None,
                              allow_mixed: bool = False) -> dict:
    """Refuse to fit a ledger whose records were measured under different
    device constants than the spec that will featurize them (ROADMAP "per-
    record device fingerprints checked at fit time").

    Each v2+ record carries the ``DeviceSpec.fingerprint()`` it was
    measured under; if the spec resolving for that record NOW (the
    ``device`` override, else the record's own device name) hashes
    differently — a recalibration, an edited persisted spec, a
    ``--device`` re-featurization — the ledger's device-scaled features
    would silently disagree with the recorded ground truth.  Raises
    ``ValueError`` listing the mismatches unless ``allow_mixed`` (CLI
    ``--allow-mixed``) opts in; pre-fingerprint records pass (nothing to
    check).  Returns ``{checked, unstamped, mismatched}`` counts."""
    mismatched: list[str] = []
    checked = unstamped = 0
    fp_cache: dict[str, str] = {}
    for r in records:
        stamped = r.get("device_fingerprint")
        if not stamped:
            unstamped += 1
            continue
        checked += 1
        name = r.get("device", "host_cpu") if device is None else device
        key = name if isinstance(name, str) else repr(name)
        if key not in fp_cache:
            fp_cache[key] = resolve_device(name).fingerprint()
        if stamped != fp_cache[key]:
            mismatched.append(
                f"{r.get('arch')}×{r.get('shape', {}).get('name')} "
                f"[{r.get('device', 'host_cpu')}]: measured under "
                f"{stamped}, would featurize under {fp_cache[key]}")
    if mismatched and not allow_mixed:
        shown = "; ".join(mismatched[:3])
        raise ValueError(
            f"{len(mismatched)}/{checked} ledger records were measured under "
            f"different device constants than the fit would use ({shown}"
            f"{' …' if len(mismatched) > 3 else ''}); re-run the campaign or "
            "pass allow_mixed=True / --allow-mixed to fit anyway")
    return {"checked": checked, "unstamped": unstamped,
            "mismatched": len(mismatched)}


def split_records(records, *, holdout_frac: float = 0.25, seed: int = 0
                  ) -> tuple[list[dict], list[dict]]:
    """Deterministic train/holdout split of ok-records, stratified nowhere —
    cells are i.i.d. grid points; the seed makes the held-out MAPE a stable
    regression metric."""
    recs = _ok_records(records)
    n_hold = int(round(holdout_frac * len(recs)))
    if len(recs) >= 4:
        n_hold = max(n_hold, 1)
    n_hold = min(n_hold, len(recs) - 2) if len(recs) > 2 else 0
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(recs))
    hold = {int(i) for i in idx[:n_hold]}
    train = [r for i, r in enumerate(recs) if i not in hold]
    heldout = [r for i, r in enumerate(recs) if i in hold]
    return train, heldout


def fit_lm_forest(
    records: list[dict],
    *,
    device: "DeviceSpec | str | None" = None,
    holdout_frac: float = 0.25,
    seed: int = 0,
    n_estimators: int = 60,
    allow_mixed: bool = False,
) -> LMForest:
    """Grow the (Γ, Φ) forests from ledger records.

    The model is fitted on the train split only; the held-out MAPEs in
    ``meta`` are therefore honest generalization numbers (the acceptance
    gate of the reference's ``benchmarks/check_thresholds.py`` compares
    them against the uncalibrated analytical path).

    ``device=None`` (the default) featurizes each record under its OWN
    recorded device — the fleet case: a multi-device campaign keeps every
    row's constants truthful, and the forest learns the device dimension.
    Pass a device only to deliberately re-featurize one campaign under
    another spec (e.g. a freshly calibrated one) — that trips the
    fingerprint guard (:func:`check_device_fingerprints`) and therefore
    needs ``allow_mixed=True``."""
    fp_check = check_device_fingerprints(_ok_records(records), device=device,
                                         allow_mixed=allow_mixed)
    train, heldout = split_records(records, holdout_frac=holdout_frac,
                                   seed=seed)
    # Query-time default coordinates: the explicit override, else the
    # (single) campaign device; a mixed-device ledger keeps per-row truth
    # in the features and the first device only as the query default.
    dev = resolve_device(device if device is not None
                         else train[0].get("device", "host_cpu"))

    def targets(recs):
        return (np.array([r["gamma_mb"] for r in recs], dtype=np.float64),
                np.array([r["phi_ms"] for r in recs], dtype=np.float64))

    X = feature_matrix(train, device=device)
    g, p = targets(train)
    forest = LMForest(n_estimators=n_estimators, seed=seed)
    forest.gamma_model.fit(X, g)
    forest.phi_model.fit(X, p)
    forest.fitted = True

    # Energy forest — only when every train row carries the v3 watts-proxy
    # column (a mixed v2/v3 ledger would teach the model that re-measured
    # cells cost 0 J).
    e = np.array([r.get("energy_j", 0.0) or 0.0 for r in train],
                 dtype=np.float64)
    if np.all(e > 0):
        forest.energy_model.fit(X, e)
        forest.energy_fitted = True

    meta = {
        "energy_fitted": forest.energy_fitted,
        "n_train": len(train), "n_heldout": len(heldout),
        "plan_hash": train[0].get("plan_hash"),
        "devices": sorted({r.get("device", "host_cpu") for r in train}),
        "device": dev.name, "device_spec": dev.to_dict(),
        "device_fingerprint": dev.fingerprint(),
        "mesh_dims": list(mesh_dims(train[0].get("mesh", "1x1"))),
        "reduced": bool(train[0].get("reduced", True)),
        "fingerprint_check": fp_check,
        "oob_gamma_mape": forest.gamma_model.oob_mape_,
        "oob_phi_mape": forest.phi_model.oob_mape_,
    }
    if heldout:
        Xh = feature_matrix(heldout, device=device)
        gh, ph = targets(heldout)
        pg, pp = forest.predict_features(Xh)
        meta["holdout_gamma_mape"] = mape(pg, gh)
        meta["holdout_phi_mape"] = mape(pp, ph)
        if forest.energy_fitted:
            eh = np.array([r.get("energy_j", 0.0) or 0.0 for r in heldout],
                          dtype=np.float64)
            if np.all(eh > 0):
                meta["holdout_energy_mape"] = mape(
                    forest.energy_model.predict(Xh), eh)
    forest.meta = meta
    return forest


def fit_hlo_constants(
    records: list[dict],
    *,
    base_device: "DeviceSpec | str | None" = None,
    name: str | None = None,
    per_class: bool = True,
    allow_mixed: bool = False,
) -> DeviceSpec:
    """NNLS-fit the cost-ledger roofline constants from the campaign ledger.

    The aggregate system — always solved, its constants landing in the
    classic DeviceSpec fields — is

        phi_s = c0 + c1·flops + c2·hbm_bytes + c3·collective_bytes

    with c ≥ 0 over the executed cells, coefficients inverted into the
    DeviceSpec denominators (``lm_roofline_terms`` divides by exactly
    these).  With ``per_class=True`` (default) and records carrying the
    v2 ``cost_classes`` breakdown, a refined system with one coefficient
    per ``decompose.LM_LATENCY_COLUMNS`` column (matmul vs elementwise vs
    collective …) is solved over the SAME cells; if its MAPE is no worse
    it lands in ``DeviceSpec.class_coeffs["lm_latency"]`` and the
    analytical backend prices ledgers class-wise.  The aggregate fit stays
    the documented fallback either way — ``meta`` records both MAPEs."""
    recs = [r for r in _ok_records(records) if r.get("phi_ms", 0) > 0]
    if len(recs) < 4:
        raise ValueError(f"need >= 4 executed cells to fit 4 constants, "
                         f"have {len(recs)}")
    check_device_fingerprints(recs, device=base_device,
                              allow_mixed=allow_mixed)
    # One NNLS system fits ONE device's constants.  A fleet ledger (the
    # forest's multi-device case) must be filtered per device first —
    # blending millisecond host rows with microsecond TPU rows would
    # 'calibrate' constants describing neither, with every per-record
    # fingerprint happily matching its own device.
    devices = {r.get("device", "host_cpu") for r in recs}
    if len(devices) > 1 and not allow_mixed:
        raise ValueError(
            f"fit_hlo_constants solves one device's constants but the "
            f"ledger spans {sorted(devices)}; filter records to a single "
            f"device or pass allow_mixed=True / --allow-mixed")
    base = resolve_device(base_device if base_device is not None
                          else recs[0].get("device", "host_cpu"))
    flops = np.array([r["flops"] for r in recs], dtype=np.float64)
    hbm = np.array([r["hbm_bytes"] for r in recs], dtype=np.float64)
    coll = np.array([r["collective_bytes"] for r in recs], dtype=np.float64)
    phi_s = np.array([r["phi_ms"] for r in recs], dtype=np.float64) / 1e3

    A = np.stack([np.ones_like(phi_s), flops, hbm, coll], axis=1)
    c = nnls(A, phi_s)
    phi_mape_agg = float(mape(A @ c, phi_s))

    # Class-wise refinement over the recorded ledger breakdowns.  Cells
    # without a breakdown (pre-v2 records) disable it — a partially
    # attributed system would bias the classes toward whichever cells
    # happened to carry one.
    class_coeffs: dict = {}
    phi_mape_cls = None
    names: list = []
    if per_class and all(r.get("cost_classes") for r in recs):
        cols = ledger_latency_columns([r["cost_classes"] for r in recs])
        names = [n for n, v in cols.items() if np.any(v)]
        if names:
            A_cls = np.stack([np.ones_like(phi_s)] + [cols[n] for n in names],
                             axis=1)
            c_cls = nnls(A_cls, phi_s)
            phi_mape_cls = float(mape(A_cls @ c_cls, phi_s))
            if phi_mape_cls <= phi_mape_agg:
                class_coeffs["lm_latency"] = {
                    "_intercept": float(c_cls[0]),
                    **{n: float(v) for n, v in zip(names, c_cls[1:])},
                }

    # Energy — fitted exactly like latency (aggregate AND class-wise NNLS
    # over the same columns, lower MAPE applied) from the schema-v3
    # watts-proxy column.  Skipped when any executed cell lacks it (a v2
    # ledger, or a zero-watt device envelope).  Whichever fit wins is
    # stored over the ledger column names ("lm_energy"): the aggregate's
    # tied coefficients map flops_*→c1, hbm_*→c2, collective→c3, so the
    # backend prices energy through one path (classwise_seconds).
    energy = np.array([r.get("energy_j", 0.0) or 0.0 for r in recs],
                      dtype=np.float64)
    energy_meta: dict = {"energy_fit": "none"}
    e_cols = e_names = A_e = ce = None
    if np.all(energy > 0):
        e_agg = nnls(A, energy)
        e_mape_agg = float(mape(A @ e_agg, energy))
        e_mape_cls = None
        use_classwise_e = False
        if per_class and all(r.get("cost_classes") for r in recs):
            e_cols = ledger_latency_columns([r["cost_classes"] for r in recs])
            e_names = [n for n, v in e_cols.items() if np.any(v)]
            if e_names:
                A_e = np.stack(
                    [np.ones_like(energy)] + [e_cols[n] for n in e_names],
                    axis=1)
                ce = nnls(A_e, energy)
                e_mape_cls = float(mape(A_e @ ce, energy))
                use_classwise_e = e_mape_cls <= e_mape_agg
        if use_classwise_e:
            class_coeffs["lm_energy"] = {
                "_intercept": float(ce[0]),
                **{n: float(v) for n, v in zip(e_names, ce[1:])},
            }
        else:
            from repro_torch.engine.decompose import LM_LATENCY_COLUMNS

            tied = {"_intercept": float(e_agg[0])}
            for n in LM_LATENCY_COLUMNS:
                tied[n] = float(e_agg[1] if n.startswith("flops_")
                                else e_agg[3] if n == "collective"
                                else e_agg[2])
            class_coeffs["lm_energy"] = tied
        energy_meta = {
            "energy_fit": "classwise" if use_classwise_e else "aggregate",
            "energy_mape": (e_mape_cls if use_classwise_e else e_mape_agg),
            "energy_mape_aggregate": e_mape_agg,
            "energy_mape_classwise": e_mape_cls,
        }

    # Inert (never-binding) terms keep a finite, serializable denominator.
    spec = replace(
        base,
        name=name or f"{base.name}_lm_calibrated",
        peak_flops=1.0 / c[1] if c[1] > 0 else 1e18,
        hbm_bw=1.0 / c[2] if c[2] > 0 else 1e18,
        ici_bw=1.0 / c[3] if c[3] > 0 else 1e18,
        launch_overhead_s=float(c[0]),
        combine="sum",
        calibrated=True,
        class_coeffs={**{k: v for k, v in base.class_coeffs.items()
                         if k not in ("lm_latency", "lm_energy")},
                      **class_coeffs},
        meta={
            "base_device": base.name,
            "n_cells": len(recs),
            "plan_hash": recs[0].get("plan_hash"),
            "phi_mape": (phi_mape_cls if "lm_latency" in class_coeffs
                         else phi_mape_agg),
            "phi_mape_aggregate": phi_mape_agg,
            "phi_mape_classwise": phi_mape_cls,
            "latency_fit": ("classwise" if "lm_latency" in class_coeffs
                            else "aggregate"),
            "fit": "campaign_hlo_nnls",
            # Collective-calibration audit trail (the >1-device smoke
            # grid — campaign/plan.collective_smoke_plan — exists to make
            # these meaningful): how many fitted cells actually moved
            # collective bytes, whether the collective column entered the
            # class-wise system, and both fitted prices.  The planner's
            # collective_seconds() uses the class-wise coefficient when
            # present, so benchmarks gate on these fields.
            "collective_cells": int(np.sum(coll > 0)),
            "collective_column_fitted": bool("collective" in names),
            "collective_coeff_aggregate": float(c[3]),
            "collective_coeff_classwise": (
                class_coeffs.get("lm_latency", {}).get("collective")),
            "classwise_columns": list(names),
            **energy_meta,
        },
    )
    # Self-check through the shared terms: predictions must reproduce the
    # fitted systems exactly (aggregate via lm_roofline_terms, class-wise
    # via the shared classwise_seconds pricing).  An inert term keeps its
    # 1e18 denominator and still adds column / 1e18 seconds (0.1 ms at
    # the card's 1e14 FLOPs, past the rtol, where the reference's check
    # raises): the whole sum is held within the largest such addition.
    t = lm_roofline_terms(flops, hbm, coll, spec)
    inert = sum(term for term, ci in zip(t, c[1:]) if ci <= 0)
    assert np.allclose(spec.launch_overhead_s + sum(t), A @ c, rtol=1e-6,
                       atol=float(np.max(inert)))
    if "lm_latency" in class_coeffs:
        pred = classwise_seconds(cols, spec.class_coeffs["lm_latency"])
        assert np.allclose(pred, A_cls @ c_cls, rtol=1e-6)
    if e_cols is not None and A_e is not None \
            and spec.meta["energy_fit"] == "classwise":
        pred_e = classwise_seconds(e_cols, spec.class_coeffs["lm_energy"])
        assert np.allclose(pred_e, A_e @ ce, rtol=1e-6)
    return spec


def register_lm_forest(target, forest: LMForest):
    """Attach a fitted forest to the engine's prediction path.

    ``target`` may be a :class:`~repro_torch.engine.engine.CostEngine`, an
    :class:`~repro_torch.engine.backends.EnsembleBackend`, or a
    :class:`~repro_torch.engine.backends.ForestBackend`; the first ForestBackend
    found gets ``forest`` as its LM model (its ``cache_salt`` changes with
    it, so stale on-disk estimates can't be served).  Returns the backend
    that now owns the forest."""
    from repro_torch.engine.backends import EnsembleBackend, ForestBackend
    from repro_torch.engine.engine import CostEngine

    if isinstance(target, CostEngine):
        return register_lm_forest(target.backend, forest)
    if isinstance(target, EnsembleBackend):
        for b in target.backends:
            if isinstance(b, ForestBackend):
                return register_lm_forest(b, forest)
        raise ValueError("no ForestBackend in the ensemble chain to attach "
                         "the LM forest to")
    if isinstance(target, ForestBackend):
        target.lm = forest
        return target
    raise TypeError(f"cannot register an LM forest on {type(target).__name__}")
