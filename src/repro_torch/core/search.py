"""Evolutionary architecture search under hard resource constraints —
the paper's on-device OFA case study (§6.4), generalised (port of
``repro/core/search.py``, numpy only: the same seed and the same engine
answers give the reference's ``SearchResult``, every field but
``search_time_s``).

The paper runs [3]'s evolutionary search: population 100, 500 iterations,
every sampled sub-network needs (Γ, γ, φ) estimates.  Profiling costs ~20 s
per sample on-device (11 days for 50 000 samples) and risks OOM-killing
co-located safety-critical processes; the perf4sight predictor costs ~0.1 s
on CPU (1.4 h) — a ~200× search-time gain.

Since the engine refactor the search talks to the unified
:class:`~repro_torch.engine.CostBackend` API and evaluates WHOLE POPULATIONS in
one batched ``estimate`` call per stage: one vectorized feature-matrix
build + one packed forest traversal for all N candidates, instead of N
scalar predictor round-trips per generation.

Here the search space is the pruned-topology space of a base CNN (the
reproduction analogue of OFA sub-network sampling: per-group keep ratios
define a sub-network of the unpruned super-network).  Fitness is total kept
filters (a monotone accuracy proxy — more capacity, better accuracy, as in
the paper's MIN < A/B < MAX ordering), maximised subject to hard constraints
on predicted training memory Γ, inference memory γ and inference latency φ.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.models.cnn import CNN_BUILDERS

# NOTE: repro_torch.engine is imported lazily inside the functions that need
# it — the core layer must stay importable without dragging in the engine
# stack, and the engine package itself imports core modules.

__all__ = ["Constraints", "SearchResult", "evolutionary_search",
           "sample_subnetwork", "fold_population"]


@dataclass
class Constraints:
    gamma_mb: float | None = None        # training memory budget (Γ)
    gamma_inf_mb: float | None = None    # inference memory budget (γ)
    phi_inf_ms: float | None = None      # inference latency budget (φ)
    train_bs: int = 32
    infer_bs: int = 1


@dataclass
class SearchResult:
    widths: dict[str, int]
    fitness: float
    gamma_mb: float
    gamma_inf_mb: float
    phi_inf_ms: float
    evaluations: int
    search_time_s: float
    history: list[float] = field(default_factory=list)


def sample_subnetwork(
    canonical: dict[str, int], rng: np.random.Generator, min_ch: int = 2
) -> dict[str, int]:
    """Sample per-group keep ratios uniformly in [0.1, 1.0] (OFA-style)."""
    return {
        g: max(min_ch, int(round(n * rng.uniform(0.1, 1.0))))
        for g, n in canonical.items()
    }


def _mutate(
    widths: dict[str, int],
    canonical: dict[str, int],
    rng: np.random.Generator,
    rate: float = 0.2,
    min_ch: int = 2,
) -> dict[str, int]:
    out = dict(widths)
    for g in canonical:
        if rng.random() < rate:
            out[g] = max(min_ch, int(round(canonical[g] * rng.uniform(0.1, 1.0))))
    return out


def _crossover(a: dict[str, int], b: dict[str, int], rng: np.random.Generator) -> dict[str, int]:
    return {g: (a[g] if rng.random() < 0.5 else b[g]) for g in a}


def fold_population(
    widths_list: list[dict[str, int]],
) -> tuple[list[dict[str, int]], list[int]]:
    """Fold identical width dicts to unique entries + a fan-in index.

    Converged populations produce many identical candidates (crossover of
    identical parents, low-rate mutation); each duplicate would otherwise
    pay a full model build + feature build + engine query.  Returns
    ``(unique, fan_in)`` with ``unique[fan_in[i]]`` the representative of
    candidate ``i``.
    """
    uniq_index: dict[tuple, int] = {}
    unique: list[dict[str, int]] = []
    fan_in: list[int] = []
    for w in widths_list:
        key = tuple(sorted(w.items()))
        if key not in uniq_index:
            uniq_index[key] = len(unique)
            unique.append(w)
        fan_in.append(uniq_index[key])
    return unique, fan_in


def _as_engine(backend) -> "CostEngine":
    """Accept a CostEngine, any CostBackend, or (train, infer) Perf4Sight
    predictors (the pre-engine calling convention)."""
    from repro_torch.engine.engine import CostEngine

    if isinstance(backend, CostEngine):
        return backend
    if isinstance(backend, tuple):
        from repro_torch.engine.backends import ForestBackend

        train, infer = backend
        return CostEngine(ForestBackend(train=train, infer=infer))
    from repro_torch.core.predictor import Perf4Sight

    if isinstance(backend, Perf4Sight):
        from repro_torch.engine.backends import ForestBackend

        return CostEngine(ForestBackend(train=backend, infer=backend))
    return CostEngine(backend)


def evolutionary_search(
    family: str,
    backend,
    constraints: Constraints,
    *,
    population: int = 100,
    iterations: int = 500,
    parent_frac: float = 0.25,
    mutate_prob: float = 0.5,
    width_mult: float = 0.25,
    input_hw: int = 16,
    seed: int = 0,
) -> SearchResult:
    """Paper §6.4 ES: population of sub-networks, constraint-checked via the
    cost engine, evolved toward maximum capacity within budget.

    ``backend`` is a :class:`~repro_torch.engine.CostEngine`, any
    :class:`~repro_torch.engine.CostBackend`, or a ``(predictor_train,
    predictor_infer)`` tuple of fitted :class:`Perf4Sight` models.  Every
    generation is scored with ONE batched ``estimate`` call per stage.
    """
    from repro_torch.engine.types import STAGE_INFER, STAGE_TRAIN, CostQuery

    engine = _as_engine(backend)
    rng = np.random.default_rng(seed)
    build = CNN_BUILDERS[family]
    canonical = build(width_mult=width_mult, input_hw=input_hw).widths
    t0 = time.perf_counter()
    evaluations = 0

    def evaluate_population(
        widths_list: list[dict[str, int]],
    ) -> list[tuple[float, float, float, float]]:
        """Batched: (fitness (-inf if constraints violated), Γ, γ, φ) per
        candidate, from two engine calls covering the whole population.

        Identical width dicts within a generation (converged populations
        produce many, via crossover of identical parents) are folded to ONE
        model build + feature build + query; results fan back out per
        candidate.
        """
        nonlocal evaluations
        evaluations += len(widths_list)
        uniq_widths, fan_in = fold_population(widths_list)
        specs = [
            build(widths=w, input_hw=input_hw).conv_specs() for w in uniq_widths
        ]
        uniq_t = engine.estimate(
            [CostQuery(spec=s, bs=constraints.train_bs, stage=STAGE_TRAIN)
             for s in specs])
        uniq_i = engine.estimate(
            [CostQuery(spec=s, bs=constraints.infer_bs, stage=STAGE_INFER)
             for s in specs])
        est_t = [uniq_t[j] for j in fan_in]
        est_i = [uniq_i[j] for j in fan_in]
        out = []
        for w, et, ei in zip(widths_list, est_t, est_i):
            g_train, g_inf, p_inf = et.gamma_mb, ei.gamma_mb, ei.phi_ms
            ok = (
                (constraints.gamma_mb is None or g_train <= constraints.gamma_mb)
                and (constraints.gamma_inf_mb is None or g_inf <= constraints.gamma_inf_mb)
                and (constraints.phi_inf_ms is None or p_inf <= constraints.phi_inf_ms)
            )
            fitness = float(sum(w.values())) if ok else -np.inf
            out.append((fitness, g_train, g_inf, p_inf))
        return out

    pop = [sample_subnetwork(canonical, rng) for _ in range(population)]
    scored = list(zip(evaluate_population(pop), pop))
    history = []
    n_parents = max(2, int(parent_frac * population))
    for _ in range(iterations):
        scored.sort(key=lambda sw: sw[0][0], reverse=True)
        history.append(scored[0][0][0])
        parents = [w for (_, w) in scored[:n_parents]]
        children = []
        for _ in range(population - n_parents):
            if rng.random() < mutate_prob:
                child = _mutate(parents[rng.integers(len(parents))], canonical, rng)
            else:
                a, b = rng.choice(len(parents), 2, replace=False)
                child = _crossover(parents[a], parents[b], rng)
            children.append(child)
        scored = scored[:n_parents] + list(zip(evaluate_population(children), children))

    scored.sort(key=lambda sw: sw[0][0], reverse=True)
    (fitness, g_t, g_i, p_i), best = scored[0]
    return SearchResult(
        widths=best,
        fitness=fitness,
        gamma_mb=g_t,
        gamma_inf_mb=g_i,
        phi_inf_ms=p_i,
        evaluations=evaluations,
        search_time_s=time.perf_counter() - t0,
        history=history,
    )
