"""Random forest regressor (paper §5.2, citing Breiman 2001).

(Copy of ``repro/core/forest.py``: numpy only, held exactly.)

Bootstrap-aggregated :class:`~repro_torch.core.tree.RegressionTree`s with per-node
feature subsampling, out-of-bag (OOB) error estimation and aggregated feature
importances.  One forest is trained per modelled attribute (Γ memory,
Φ latency) — paper §5.3.
"""

from __future__ import annotations

import numpy as np

from .tree import RegressionTree

__all__ = ["RandomForestRegressor"]


class RandomForestRegressor:
    def __init__(
        self,
        n_estimators: int = 100,
        max_depth: int | None = None,
        min_samples_leaf: int = 1,
        min_samples_split: int = 2,
        max_features: int | float | str | None = "third",
        bootstrap: bool = True,
        seed: int = 0,
    ):
        self.n_estimators = int(n_estimators)
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.min_samples_split = min_samples_split
        self.max_features = max_features
        self.bootstrap = bootstrap
        self.seed = seed
        self.trees_: list[RegressionTree] = []
        self.oob_prediction_: np.ndarray | None = None
        self.oob_mape_: float | None = None
        self.feature_importances_: np.ndarray | None = None
        self._y_min: float | None = None
        self._y_max: float | None = None
        self._packed: tuple | None = None  # lazily-built flat forest arrays

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForestRegressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n = len(y)
        if n == 0:
            raise ValueError("empty training set")
        root = np.random.default_rng(self.seed)
        self.trees_ = []
        oob_sum = np.zeros(n)
        oob_cnt = np.zeros(n)
        importances = np.zeros(X.shape[1])
        for t in range(self.n_estimators):
            rng = np.random.default_rng(root.integers(2**63))
            if self.bootstrap:
                idx = rng.integers(0, n, size=n)
            else:
                idx = np.arange(n)
            tree = RegressionTree(
                max_depth=self.max_depth,
                min_samples_leaf=self.min_samples_leaf,
                min_samples_split=self.min_samples_split,
                max_features=self.max_features,
                rng=rng,
            ).fit(X[idx], y[idx])
            self.trees_.append(tree)
            importances += tree.feature_importances_
            if self.bootstrap:
                oob_mask = np.ones(n, dtype=bool)
                oob_mask[np.unique(idx)] = False
                if oob_mask.any():
                    oob_sum[oob_mask] += tree.predict(X[oob_mask])
                    oob_cnt[oob_mask] += 1
        total = importances.sum()
        self.feature_importances_ = importances / total if total > 0 else importances
        if self.bootstrap and (oob_cnt > 0).any():
            covered = oob_cnt > 0
            oob_pred = np.full(n, np.nan)
            oob_pred[covered] = oob_sum[covered] / oob_cnt[covered]
            self.oob_prediction_ = oob_pred
            denom = np.where(np.abs(y[covered]) > 1e-12, np.abs(y[covered]), 1.0)
            self.oob_mape_ = float(
                np.mean(np.abs(oob_pred[covered] - y[covered]) / denom)
            )
        self._y_min, self._y_max = float(y.min()), float(y.max())
        self._packed = None
        return self

    # -- vectorized prediction ----------------------------------------------
    #
    # All trees are concatenated into one flat node-array set (child indices
    # rebased to global node ids).  Prediction then walks every (tree, sample)
    # pair simultaneously: a (T, S) position matrix descends one level per
    # numpy iteration, so the cost is max-depth gathers instead of a Python
    # loop over T trees.

    def _pack(self) -> tuple:
        if self._packed is None:
            offsets = np.zeros(len(self.trees_) + 1, dtype=np.int64)
            for i, t in enumerate(self.trees_):
                offsets[i + 1] = offsets[i] + len(t._feat)
            feat = np.concatenate([t._feat for t in self.trees_])
            thr = np.concatenate([t._thr for t in self.trees_])
            val = np.concatenate([t._val for t in self.trees_])
            left = np.concatenate([
                np.where(t._left >= 0, t._left + off, -1)
                for t, off in zip(self.trees_, offsets[:-1])
            ])
            right = np.concatenate([
                np.where(t._right >= 0, t._right + off, -1)
                for t, off in zip(self.trees_, offsets[:-1])
            ])
            self._packed = (offsets, feat, thr, left, right, val)
        return self._packed

    def predict(self, X: np.ndarray) -> np.ndarray:
        if not self.trees_:
            raise RuntimeError("forest not fitted")
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        offsets, feat, thr, left, right, val = self._pack()
        n_samples = len(X)
        pos = np.broadcast_to(
            offsets[:-1][:, None], (len(self.trees_), n_samples)
        ).copy()
        cols = np.arange(n_samples)[None, :]
        while True:
            f = feat[pos]
            internal = f >= 0
            if not internal.any():
                break
            xv = X[cols, np.where(internal, f, 0)]
            go_left = xv <= thr[pos]
            nxt = np.where(go_left, left[pos], right[pos])
            pos = np.where(internal, nxt, pos)
        return val[pos].mean(axis=0)

    def _predict_per_tree(self, X: np.ndarray) -> np.ndarray:
        """Reference path: average of per-tree predictions (kept for parity
        tests against the packed vectorized traversal)."""
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        acc = np.zeros(len(X))
        for tree in self.trees_:
            acc += tree.predict(X)
        return acc / len(self.trees_)

    def content_hash(self) -> str:
        """Hash of the fitted forest structure (cache-key salt: estimates
        produced by different fitted models must never alias).  Memoized per
        packing — a refit invalidates the packed arrays and thus the hash."""
        import hashlib

        packed = self._pack()
        cached = getattr(self, "_content_hash", None)
        if cached is not None and cached[0] is packed:
            return cached[1]
        h = hashlib.sha1()
        for a in packed:  # offsets, feat, thr, left, right, val — all of them
            h.update(np.ascontiguousarray(a).tobytes())
        digest = h.hexdigest()
        self._content_hash = (packed, digest)
        return digest

    # -- persistence (used by the launcher's admission controller) ----------

    def to_arrays(self, prefix: str = "") -> dict[str, np.ndarray]:
        """Flat-array form of the fitted forest (NPZ-serializable): the packed
        node arrays plus per-tree offsets — far more compact than the nested
        JSON tree dicts for production-size forests."""
        if not self.trees_:
            raise RuntimeError("forest not fitted")
        offsets, feat, thr, left, right, val = self._pack()
        y_min = np.nan if self._y_min is None else self._y_min
        y_max = np.nan if self._y_max is None else self._y_max
        return {
            prefix + "offsets": offsets,
            prefix + "feat": feat,
            prefix + "thr": thr,
            prefix + "left": left,
            prefix + "right": right,
            prefix + "val": val,
            prefix + "meta": np.array(
                [float(self.trees_[0].n_features_), y_min, y_max]
            ),
        }

    @classmethod
    def from_arrays(cls, arrays, prefix: str = "") -> "RandomForestRegressor":
        offsets = np.asarray(arrays[prefix + "offsets"], dtype=np.int64)
        feat = np.asarray(arrays[prefix + "feat"], dtype=np.int64)
        thr = np.asarray(arrays[prefix + "thr"], dtype=np.float64)
        left = np.asarray(arrays[prefix + "left"], dtype=np.int64)
        right = np.asarray(arrays[prefix + "right"], dtype=np.int64)
        val = np.asarray(arrays[prefix + "val"], dtype=np.float64)
        meta = np.asarray(arrays[prefix + "meta"], dtype=np.float64)
        n_features = int(meta[0])
        self = cls(n_estimators=len(offsets) - 1)
        self._y_min = None if np.isnan(meta[1]) else float(meta[1])
        self._y_max = None if np.isnan(meta[2]) else float(meta[2])
        self.trees_ = []
        for i in range(len(offsets) - 1):
            lo, hi = offsets[i], offsets[i + 1]
            t = RegressionTree()
            t.n_features_ = n_features
            t._feat = feat[lo:hi].copy()
            t._thr = thr[lo:hi].copy()
            t._left = np.where(feat[lo:hi] >= 0, left[lo:hi] - lo, -1)
            t._right = np.where(feat[lo:hi] >= 0, right[lo:hi] - lo, -1)
            t._val = val[lo:hi].copy()
            self.trees_.append(t)
        return self

    def to_dict(self) -> dict:
        trees = []
        for t in self.trees_:
            trees.append(
                {
                    "feat": t._feat.tolist(),
                    "thr": t._thr.tolist(),
                    "left": t._left.tolist(),
                    "right": t._right.tolist(),
                    "val": t._val.tolist(),
                    "n_features": t.n_features_,
                }
            )
        return {
            "trees": trees,
            "y_min": self._y_min,
            "y_max": self._y_max,
            "params": {
                "n_estimators": self.n_estimators,
                "max_depth": self.max_depth,
                "min_samples_leaf": self.min_samples_leaf,
                "max_features": self.max_features,
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "RandomForestRegressor":
        self = cls(n_estimators=len(d["trees"]))
        self._y_min = d.get("y_min")
        self._y_max = d.get("y_max")
        self.trees_ = []
        for td in d["trees"]:
            t = RegressionTree()
            t.n_features_ = td["n_features"]
            t._feat = np.array(td["feat"], dtype=np.int64)
            t._thr = np.array(td["thr"], dtype=np.float64)
            t._left = np.array(td["left"], dtype=np.int64)
            t._right = np.array(td["right"], dtype=np.int64)
            t._val = np.array(td["val"], dtype=np.float64)
            self.trees_.append(t)
        return self
