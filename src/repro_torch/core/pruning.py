"""Structured filter pruning — the paper's topology generator (§5.1, §6.2).

(Port of ``repro/core/pruning.py``: numpy only over the port's CNN zoo,
so widths equal the reference's exactly for every family, strategy, level
and seed; ``l1_scores`` sums the HWIO axes of the numpy init.)

The profiling process derives training datapoints by structurally pruning a
base network: removing entire convolution filters.  Strategies:

  * ``random``  — paper §6.2 "randomly pruning filters with equal probability
    across all layers": a global pool of all filters, each equally likely to
    be pruned ⇒ per-group counts follow a multivariate hypergeometric.
  * ``l1``      — paper Fig.3 test strategy: globally prune the filters with
    the smallest L1 norm first (scores from an initialised model).
  * ``uniform`` — keep round(n·(1−level)) per group (paper §6.2's "uniform"
    variant among the 100 strategies).
  * ``early`` / ``middle`` / ``late`` — position-biased profiles (paper §6.2:
    "increased pruning at early, late or middle layers").

All strategies return a new ``widths`` dict; the CNN builders rebuild the
pruned topology from it.  A floor of ``min_ch`` filters per group keeps every
topology valid.
"""

from __future__ import annotations

import numpy as np

from repro_torch.models.cnn import CNN_BUILDERS, CNNModel, iter_tagged

__all__ = ["prune_widths", "l1_scores", "random_profile_widths", "pruned_model",
           "PRUNE_STRATEGIES"]

PRUNE_STRATEGIES = ("random", "l1", "uniform", "early", "middle", "late")


def _position_weights(n_groups: int, profile: str) -> np.ndarray:
    """Relative pruning propensity per group position (order of widths dict)."""
    x = np.linspace(0.0, 1.0, n_groups)
    if profile == "early":
        w = 1.0 - x
    elif profile == "late":
        w = x
    elif profile == "middle":
        w = 1.0 - np.abs(x - 0.5) * 2.0
    else:
        raise ValueError(profile)
    return w + 0.15  # keep strictly positive so every group can lose filters


def prune_widths(
    canonical: dict[str, int],
    level: float,
    strategy: str = "random",
    rng: np.random.Generator | None = None,
    min_ch: int = 2,
    scores: dict[str, np.ndarray] | None = None,
) -> dict[str, int]:
    """Derive a pruned ``widths`` dict from ``canonical`` at ``level``∈[0,1)."""
    if not 0.0 <= level < 1.0:
        raise ValueError(f"pruning level must be in [0,1): {level}")
    if level == 0.0:
        return dict(canonical)
    rng = rng or np.random.default_rng(0)
    groups = list(canonical.keys())
    sizes = np.array([canonical[g] for g in groups], dtype=np.int64)
    total = int(sizes.sum())
    n_prune = int(round(level * total))

    if strategy == "uniform":
        kept = np.maximum(min_ch, np.round(sizes * (1.0 - level)).astype(np.int64))
    elif strategy == "random":
        pruned = rng.multivariate_hypergeometric(sizes, n_prune)
        kept = np.maximum(min_ch, sizes - pruned)
    elif strategy == "l1":
        if scores is None:
            raise ValueError("l1 strategy requires per-group filter scores")
        flat_scores, owner = [], []
        for gi, g in enumerate(groups):
            s = np.asarray(scores[g], dtype=np.float64)
            if len(s) != canonical[g]:
                raise ValueError(f"score length mismatch for group {g}")
            flat_scores.append(s)
            owner.append(np.full(len(s), gi))
        flat_scores = np.concatenate(flat_scores)
        owner = np.concatenate(owner)
        order = np.argsort(flat_scores, kind="stable")[:n_prune]
        pruned = np.bincount(owner[order], minlength=len(groups))
        kept = np.maximum(min_ch, sizes - pruned)
    elif strategy in ("early", "middle", "late"):
        w = _position_weights(len(groups), strategy)
        # Per-group prune counts proportional to weight · size, iteratively
        # clipped so no group drops below min_ch while the total stays ~level.
        budget = n_prune
        kept = sizes.copy()
        for _ in range(8):
            room = kept - min_ch
            active = room > 0
            if budget <= 0 or not active.any():
                break
            alloc = w * sizes
            alloc = np.where(active, alloc, 0.0)
            if alloc.sum() == 0:
                break
            take = np.minimum(room, np.round(alloc / alloc.sum() * budget).astype(np.int64))
            kept = kept - take
            budget -= int(take.sum())
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return {g: int(k) for g, k in zip(groups, kept)}


def random_profile_widths(
    canonical: dict[str, int],
    level: float,
    rng: np.random.Generator,
    min_ch: int = 2,
) -> dict[str, int]:
    """Paper §6.2: one of "100 random pruning strategies" — per-group pruning
    ratios drawn from a Dirichlet around the target level (includes heavily
    non-uniform allocations)."""
    groups = list(canonical.keys())
    sizes = np.array([canonical[g] for g in groups], dtype=np.float64)
    total = sizes.sum()
    n_prune = level * total
    alloc = rng.dirichlet(np.full(len(groups), 1.5)) * n_prune
    kept = np.maximum(min_ch, np.round(sizes - np.minimum(alloc, sizes - min_ch)))
    return {g: int(k) for g, k in zip(groups, kept)}


def l1_scores(model: CNNModel, seed: int = 0) -> dict[str, np.ndarray]:
    """Per-group per-filter L1 norms from an initialised model (the paper
    scores a trained model; at reproduction scale the init-weight L1 plays the
    same role: a deterministic, non-uniform global ranking)."""
    params = model.init(seed)
    out: dict[str, np.ndarray] = {}
    for group, node, p in iter_tagged(model.graph, params):
        if group in out:
            continue  # first occurrence is the primary producer
        w = np.asarray(p["w"])
        if w.ndim == 4:  # HWIO conv: per-filter sum over (k,k,cin)
            out[group] = np.abs(w).sum(axis=(0, 1, 2))
        else:  # dense (cin, cout)
            out[group] = np.abs(w).sum(axis=0)
    return out


def pruned_model(
    family: str,
    level: float,
    strategy: str = "random",
    seed: int = 0,
    width_mult: float = 1.0,
    input_hw: int = 32,
) -> CNNModel:
    """Convenience: canonical model → pruned widths → rebuilt model."""
    build = CNN_BUILDERS[family]
    base = build(width_mult=width_mult, input_hw=input_hw)
    rng = np.random.default_rng(seed)
    scores = l1_scores(base, seed) if strategy == "l1" else None
    widths = prune_widths(base.widths, level, strategy, rng, scores=scores)
    m = build(widths=widths, input_hw=input_hw)
    m.name = f"{family}-p{int(level * 100)}-{strategy}"
    return m
