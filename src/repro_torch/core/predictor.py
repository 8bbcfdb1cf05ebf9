"""perf4sight predictor (paper Fig. 2): analytical features + profiled
datapoints → one random forest per attribute (Γ, Φ) → fast prediction and
admission control.

(Port of ``repro/core/predictor.py``, held exactly: numpy only, over the
port's copies of ``features``, ``forest`` and ``fileio`` and its own
``dataset``.  A predictor saved as NPZ or JSON by either package loads
in the other.)

The fitted predictor is the framework's *admission controller*: the launcher
asks it whether a (model, batch size) training job fits the device's memory
and latency budget before any device allocation happens — the paper's
safety-critical motivation (§1, §6.4), promoted to a first-class feature.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from repro_torch.core.dataset import Datapoint, features_targets
from repro_torch.core.features import NetworkSpec, feature_matrix, network_features
from repro_torch.core.fileio import atomic_write_bytes, atomic_write_json
from repro_torch.core.forest import RandomForestRegressor

__all__ = ["Perf4Sight", "EvalReport", "mape"]


def mape(pred: np.ndarray, true: np.ndarray) -> float:
    """Mean absolute percentage error (the paper's attribute-error metric)."""
    true = np.asarray(true, dtype=np.float64)
    denom = np.where(np.abs(true) > 1e-12, np.abs(true), 1.0)
    return float(np.mean(np.abs(np.asarray(pred) - true) / denom))


@dataclass
class EvalReport:
    gamma_mape: float
    phi_mape: float
    n: int

    def __str__(self) -> str:
        return (
            f"Γ error {self.gamma_mape * 100:.2f}% | Φ error {self.phi_mape * 100:.2f}% "
            f"({self.n} test points)"
        )


class HybridRegressor:
    """Ridge over the analytical features + random forest on the residual.

    The paper observes both attributes are linear in batch size with a
    topology-dependent fit (App. B); the ridge captures that global linear
    structure (which a 20-point forest cannot extrapolate), the forest
    captures the framework/device-specific nonlinearity — the same
    analytical+learned split as the paper's Fig. 2, one level deeper.
    Beyond-paper addition, decisive in the small-profiling-grid regime
    (EXPERIMENTS.md §Reproduction)."""

    def __init__(self, alpha: float = 1e-2, seed: int = 0, **forest_kw):
        self.alpha = alpha
        self.forest = RandomForestRegressor(seed=seed, **forest_kw)
        self._lin: tuple | None = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "HybridRegressor":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        mu, sd = X.mean(0), X.std(0) + 1e-12
        Xn = (X - mu) / sd
        A = Xn.T @ Xn + self.alpha * len(y) * np.eye(X.shape[1])
        w = np.linalg.solve(A, Xn.T @ (y - y.mean()))
        self._lin = (mu, sd, w, float(y.mean()))
        self.forest.fit(X, y - self._linear(X))
        self.oob_mape_ = self.forest.oob_mape_
        return self

    def _linear(self, X: np.ndarray) -> np.ndarray:
        mu, sd, w, b = self._lin
        return ((np.asarray(X, np.float64) - mu) / sd) @ w + b

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, np.float64))
        return self._linear(X) + self.forest.predict(X)

    def to_dict(self) -> dict:
        mu, sd, w, b = self._lin
        return {"hybrid": True, "alpha": self.alpha,
                "lin": {"mu": mu.tolist(), "sd": sd.tolist(),
                        "w": w.tolist(), "b": b},
                "forest": self.forest.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "HybridRegressor":
        self = cls(alpha=d.get("alpha", 1e-2))
        lin = d["lin"]
        self._lin = (np.array(lin["mu"]), np.array(lin["sd"]),
                     np.array(lin["w"]), float(lin["b"]))
        self.forest = RandomForestRegressor.from_dict(d["forest"])
        return self

    def content_hash(self) -> str:
        import hashlib

        mu, sd, w, b = self._lin
        h = hashlib.sha1()
        for a in (mu, sd, w):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(np.float64(b).tobytes())
        h.update(self.forest.content_hash().encode())
        return h.hexdigest()

    def to_arrays(self, prefix: str = "") -> dict:
        mu, sd, w, b = self._lin
        out = {
            prefix + "lin_mu": mu,
            prefix + "lin_sd": sd,
            prefix + "lin_w": w,
            prefix + "lin_b": np.array([b, self.alpha]),
        }
        out.update(self.forest.to_arrays(prefix + "forest_"))
        return out

    @classmethod
    def from_arrays(cls, arrays, prefix: str = "") -> "HybridRegressor":
        b_alpha = np.asarray(arrays[prefix + "lin_b"], dtype=np.float64)
        self = cls(alpha=float(b_alpha[1]))
        self._lin = (
            np.asarray(arrays[prefix + "lin_mu"], dtype=np.float64),
            np.asarray(arrays[prefix + "lin_sd"], dtype=np.float64),
            np.asarray(arrays[prefix + "lin_w"], dtype=np.float64),
            float(b_alpha[0]),
        )
        self.forest = RandomForestRegressor.from_arrays(arrays, prefix + "forest_")
        return self


class Perf4Sight:
    """Two regressors (Γ memory MB, Φ latency ms) over the 42 features —
    hybrid ridge+forest by default, pure forest with ``hybrid=False``
    (the paper-faithful baseline)."""

    def __init__(
        self,
        n_estimators: int = 100,
        min_samples_leaf: int = 1,
        max_features: int | float | str | None = "third",
        seed: int = 0,
        hybrid: bool = True,
    ):
        kw = dict(
            n_estimators=n_estimators,
            min_samples_leaf=min_samples_leaf,
            max_features=max_features,
        )
        if hybrid:
            self.gamma_model = HybridRegressor(seed=seed, **kw)
            self.phi_model = HybridRegressor(seed=seed + 1, **kw)
        else:
            self.gamma_model = RandomForestRegressor(seed=seed, **kw)
            self.phi_model = RandomForestRegressor(seed=seed + 1, **kw)
        self.fitted = False

    # -- training ------------------------------------------------------------

    def fit(self, datapoints: list[Datapoint]) -> "Perf4Sight":
        X, g, p = features_targets(datapoints)
        self.gamma_model.fit(X, g)
        self.phi_model.fit(X, p)
        self.fitted = True
        return self

    def fit_arrays(self, X: np.ndarray, gamma: np.ndarray, phi: np.ndarray) -> "Perf4Sight":
        self.gamma_model.fit(X, gamma)
        self.phi_model.fit(X, phi)
        self.fitted = True
        return self

    # -- prediction ----------------------------------------------------------

    def predict_features(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return self.gamma_model.predict(X), self.phi_model.predict(X)

    def predict(self, spec: NetworkSpec, bs: int) -> tuple[float, float]:
        """(Γ MB, Φ ms) for a network spec at batch size ``bs`` — pure
        Python + numpy, ~0.1 ms (paper §6.4 requires no-GPU, sub-second)."""
        x = network_features(spec, bs)[None, :]
        g, p = self.predict_features(x)
        return float(g[0]), float(p[0])

    def content_hash(self) -> str:
        """Hash of both fitted models — salts engine cache keys so estimates
        from differently-fitted predictors never alias on disk."""
        import hashlib

        h = hashlib.sha1()
        h.update(self.gamma_model.content_hash().encode())
        h.update(self.phi_model.content_hash().encode())
        return h.hexdigest()

    def predict_batch(
        self, specs_and_bs: list[tuple[NetworkSpec, int]]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched (Γ, Φ) for N (spec, batch size) candidates: one vectorized
        feature-matrix build + one forest traversal per attribute, instead of
        N scalar round-trips (the engine/search fast path)."""
        if not specs_and_bs:
            return np.zeros(0), np.zeros(0)
        X = feature_matrix(specs_and_bs)
        return self.predict_features(X)

    def evaluate(self, datapoints: list[Datapoint]) -> EvalReport:
        X, g, p = features_targets(datapoints)
        pg, pp = self.predict_features(X)
        return EvalReport(gamma_mape=mape(pg, g), phi_mape=mape(pp, p), n=len(datapoints))

    # -- admission control (launcher integration) -----------------------------

    def admit(
        self,
        spec: NetworkSpec,
        bs: int,
        *,
        gamma_budget_mb: float | None = None,
        phi_budget_ms: float | None = None,
        safety_margin: float = 0.1,
    ) -> tuple[bool, dict]:
        """Gate a training job: refuse if the predicted footprint/latency
        (inflated by ``safety_margin``) exceeds the budget."""
        g, p = self.predict(spec, bs)
        g_eff, p_eff = g * (1 + safety_margin), p * (1 + safety_margin)
        ok = True
        if gamma_budget_mb is not None and g_eff > gamma_budget_mb:
            ok = False
        if phi_budget_ms is not None and p_eff > phi_budget_ms:
            ok = False
        return ok, {"gamma_mb": g, "phi_ms": p, "gamma_eff": g_eff, "phi_eff": p_eff}

    # -- persistence -----------------------------------------------------------
    #
    # Two formats, chosen by extension, so fitted forests round-trip between
    # processes (search jobs load once instead of refitting):
    #   *.json — nested tree dicts (human-inspectable, the original format)
    #   *.npz  — packed flat arrays (compact; production-size forests)
    # Both writes are atomic (tempfile in the target dir + os.replace).

    def save(self, path: str) -> None:
        if path.endswith(".npz"):
            arrays: dict[str, np.ndarray] = {}
            for prefix, model in (("gamma_", self.gamma_model),
                                  ("phi_", self.phi_model)):
                arrays[prefix + "hybrid"] = np.array(
                    [1.0 if isinstance(model, HybridRegressor) else 0.0])
                arrays.update(model.to_arrays(prefix))
            atomic_write_bytes(path, lambda f: np.savez_compressed(f, **arrays),
                               suffix=".npz")
            return
        atomic_write_json(path, {"gamma": self.gamma_model.to_dict(),
                                 "phi": self.phi_model.to_dict()})

    @classmethod
    def load(cls, path: str) -> "Perf4Sight":
        self = cls()
        if path.endswith(".npz"):
            with np.load(path) as arrays:
                models = {}
                for prefix in ("gamma_", "phi_"):
                    if float(arrays[prefix + "hybrid"][0]):
                        models[prefix] = HybridRegressor.from_arrays(arrays, prefix)
                    else:
                        models[prefix] = RandomForestRegressor.from_arrays(
                            arrays, prefix)
            self.gamma_model = models["gamma_"]
            self.phi_model = models["phi_"]
            self.fitted = True
            return self
        with open(path) as f:
            blob = json.load(f)
        loader = (
            lambda d: HybridRegressor.from_dict(d) if d.get("hybrid")
            else RandomForestRegressor.from_dict(d)
        )
        self.gamma_model = loader(blob["gamma"])
        self.phi_model = loader(blob["phi"])
        self.fitted = True
        return self
