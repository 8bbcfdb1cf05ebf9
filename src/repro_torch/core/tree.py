"""CART regression tree (paper §5.2: decision trees partition the feature
space into low-entropy regions; regression predicts the region mean).

(Copy of ``repro/core/tree.py``: numpy only, held exactly.)

Pure-numpy implementation with exact variance-reduction splits computed via
prefix sums over sorted feature columns — O(d · n log n) per node.  Supports
per-node feature subsampling (for random forests) and min-samples / max-depth
regularisation.  Trees are stored as flat arrays so prediction is a vectorised
loop over depth, not Python recursion per sample.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["RegressionTree"]

_LEAF = -1


@dataclass
class _Node:
    feature: int = _LEAF
    threshold: float = 0.0
    left: int = _LEAF
    right: int = _LEAF
    value: float = 0.0
    n_samples: int = 0
    impurity_decrease: float = 0.0


class RegressionTree:
    """Greedy CART regressor.

    Parameters
    ----------
    max_depth : depth cap (None = unbounded).
    min_samples_leaf : minimum samples in each child of a split.
    min_samples_split : minimum samples required to consider splitting.
    max_features : None (all), int, float fraction, "sqrt", or "third" —
        number of candidate features sampled per node.
    rng : numpy Generator for feature subsampling / tie-breaks.
    """

    def __init__(
        self,
        max_depth: int | None = None,
        min_samples_leaf: int = 1,
        min_samples_split: int = 2,
        max_features: int | float | str | None = None,
        rng: np.random.Generator | None = None,
    ):
        self.max_depth = max_depth
        self.min_samples_leaf = int(min_samples_leaf)
        self.min_samples_split = int(min_samples_split)
        self.max_features = max_features
        self.rng = rng or np.random.default_rng(0)
        self._nodes: list[_Node] = []
        self.n_features_: int | None = None
        self.feature_importances_: np.ndarray | None = None

    # -- fitting ----------------------------------------------------------

    def _n_candidate_features(self, d: int) -> int:
        mf = self.max_features
        if mf is None:
            return d
        if isinstance(mf, str):
            if mf == "sqrt":
                return max(1, int(np.sqrt(d)))
            if mf == "third":
                return max(1, d // 3)
            raise ValueError(f"unknown max_features {mf!r}")
        if isinstance(mf, float):
            return max(1, int(mf * d))
        return max(1, min(int(mf), d))

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RegressionTree":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if X.ndim != 2 or y.ndim != 1 or len(X) != len(y):
            raise ValueError(f"bad shapes X{X.shape} y{y.shape}")
        if len(y) == 0:
            raise ValueError("empty training set")
        self.n_features_ = X.shape[1]
        self._nodes = []
        importances = np.zeros(self.n_features_)
        # Iterative construction with an explicit stack (no recursion limit).
        root_idx = self._new_node()
        stack = [(root_idx, np.arange(len(y)), 0)]
        while stack:
            node_idx, idx, depth = stack.pop()
            node = self._nodes[node_idx]
            ysub = y[idx]
            node.value = float(ysub.mean())
            node.n_samples = len(idx)
            if (
                len(idx) < self.min_samples_split
                or (self.max_depth is not None and depth >= self.max_depth)
                or np.all(ysub == ysub[0])
            ):
                continue
            split = self._best_split(X, y, idx)
            if split is None:
                continue
            feat, thr, gain = split
            mask = X[idx, feat] <= thr
            left_idx, right_idx = idx[mask], idx[~mask]
            if len(left_idx) < self.min_samples_leaf or len(right_idx) < self.min_samples_leaf:
                continue
            node.feature = feat
            node.threshold = thr
            node.impurity_decrease = gain
            importances[feat] += gain * len(idx)
            node.left = self._new_node()
            node.right = self._new_node()
            stack.append((node.left, left_idx, depth + 1))
            stack.append((node.right, right_idx, depth + 1))
        total = importances.sum()
        self.feature_importances_ = importances / total if total > 0 else importances
        self._pack()
        return self

    def _new_node(self) -> int:
        self._nodes.append(_Node())
        return len(self._nodes) - 1

    def _best_split(
        self, X: np.ndarray, y: np.ndarray, idx: np.ndarray
    ) -> tuple[int, float, float] | None:
        """Exact best (feature, threshold) by weighted-variance reduction."""
        n = len(idx)
        ysub = y[idx]
        parent_sse = float(((ysub - ysub.mean()) ** 2).sum())
        d = X.shape[1]
        n_cand = self._n_candidate_features(d)
        feats = (
            self.rng.choice(d, size=n_cand, replace=False) if n_cand < d else np.arange(d)
        )
        best: tuple[int, float, float] | None = None
        best_gain = 1e-12  # require strictly positive gain
        msl = self.min_samples_leaf
        for f in feats:
            col = X[idx, f]
            order = np.argsort(col, kind="stable")
            cs, ys = col[order], ysub[order]
            # candidate split positions: between distinct consecutive values
            diff = cs[1:] != cs[:-1]
            if not diff.any():
                continue
            csum = np.cumsum(ys)
            csum2 = np.cumsum(ys * ys)
            total, total2 = csum[-1], csum2[-1]
            k = np.arange(1, n)  # left sizes
            valid = diff & (k >= msl) & ((n - k) >= msl)
            if not valid.any():
                continue
            lsum, lsum2 = csum[:-1], csum2[:-1]
            rsum, rsum2 = total - lsum, total2 - lsum2
            sse = (lsum2 - lsum**2 / k) + (rsum2 - rsum**2 / (n - k))
            sse = np.where(valid, sse, np.inf)
            j = int(np.argmin(sse))
            gain = parent_sse - float(sse[j])
            if gain > best_gain:
                best_gain = gain
                thr = 0.5 * (cs[j] + cs[j + 1])
                best = (int(f), float(thr), gain)
        return best

    # -- prediction --------------------------------------------------------

    def _pack(self) -> None:
        """Flatten node list to arrays for vectorised prediction."""
        n = len(self._nodes)
        self._feat = np.array([nd.feature for nd in self._nodes], dtype=np.int64)
        self._thr = np.array([nd.threshold for nd in self._nodes], dtype=np.float64)
        self._left = np.array([nd.left for nd in self._nodes], dtype=np.int64)
        self._right = np.array([nd.right for nd in self._nodes], dtype=np.int64)
        self._val = np.array([nd.value for nd in self._nodes], dtype=np.float64)

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        if self.n_features_ is None:
            raise RuntimeError("tree not fitted")
        pos = np.zeros(len(X), dtype=np.int64)
        active = self._feat[pos] != _LEAF
        while active.any():
            p = pos[active]
            f = self._feat[p]
            go_left = X[active, f] <= self._thr[p]
            pos[active] = np.where(go_left, self._left[p], self._right[p])
            active = self._feat[pos] != _LEAF
        return self._val[pos]

    # -- introspection ------------------------------------------------------

    @property
    def node_count(self) -> int:
        return len(self._nodes)

    @property
    def depth(self) -> int:
        depths = {0: 0}
        best = 0
        for i, nd in enumerate(self._nodes):
            d = depths.get(i, 0)
            best = max(best, d)
            if nd.feature != _LEAF:
                depths[nd.left] = d + 1
                depths[nd.right] = d + 1
        return best
