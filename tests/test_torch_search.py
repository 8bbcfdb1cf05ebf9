"""The port's §6.4 evolutionary search against the reference's: sub-network
sampling, mutation, crossover, population folding and whole searches at
width 0.25 and 16x16, through a forest-only engine and through a forest +
analytical ensemble.

The search is numpy over the same seeds and the same estimates, so every
field of ``SearchResult`` but ``search_time_s`` is held exactly (``==``),
and so is what the engine saw (calls, hits, misses).
"""

import dataclasses

import numpy as np
import pytest

from repro.core import dataset as ref_dataset
from repro.core import features as ref_features
from repro.core import predictor as ref_predictor
from repro.core import pruning as ref_pruning
from repro.core import search as ref_search
from repro.engine import backends as ref_backends
from repro.engine import engine as ref_engine
from repro.models import cnn as ref_cnn
from repro_torch.core import dataset, predictor, search
from repro_torch.engine import (AnalyticalBackend, CostEngine, EnsembleBackend,
                                EstimateCache, ForestBackend)
from repro_torch.models import cnn
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

WM, HW = 0.25, 16
FAMILIES = ("resnet50", "squeezenet", "mobilenetv2")


def _ref_dps(family, n=36, seed=0, infer=False):
    """Synthetic datapoints over real features of ``family`` (the recipe of
    tests/test_engine.py), as reference datapoints; ``infer`` gives the
    small-batch targets an inference predictor is fitted on."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        level = float(rng.uniform(0, 0.9))
        bs = int(rng.integers(1, 9)) if infer else int(rng.integers(2, 33))
        m = ref_pruning.pruned_model(family, level, "random", seed=int(rng.integers(5)),
                                     width_mult=WM, input_hw=HW)
        f = ref_features.network_features(m.conv_specs(), bs)
        out.append(ref_dataset.Datapoint(
            family=family, level=level, strategy="random", bs=bs, width_mult=WM,
            input_hw=HW, seed=0, gamma_mb=5.0 + f[4] / 1e5, phi_ms=2.0 + f[14] / 1e7,
            features=[float(v) for v in f]))
    return out


def _fit(dps, n_estimators=16):
    mine = predictor.Perf4Sight(n_estimators=n_estimators).fit(
        [dataset.Datapoint(**dataclasses.asdict(dp)) for dp in dps])
    ref = ref_predictor.Perf4Sight(n_estimators=n_estimators).fit(dps)
    return mine, ref


@pytest.fixture(scope="module")
def forests():
    """{family: ((port train, port infer), (ref train, ref infer))}."""
    out = {}
    for family in FAMILIES:
        (t, rt), (i, ri) = _fit(_ref_dps(family)), _fit(_ref_dps(family, seed=1, infer=True))
        out[family] = ((t, i), (rt, ri))
    return out


def _result(r):
    d = dataclasses.asdict(r)
    d.pop("search_time_s")
    return d


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(cnn.CNN_BUILDERS))
def test_sample_mutate_crossover_identical(family):
    canonical = cnn.CNN_BUILDERS[family](width_mult=WM, input_hw=HW).widths
    assert canonical == ref_cnn.CNN_BUILDERS[family](width_mult=WM, input_hw=HW).widths
    rng, ref_rng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(4):
        a, b = search.sample_subnetwork(canonical, rng), search.sample_subnetwork(canonical, rng)
        assert (a, b) == (ref_search.sample_subnetwork(canonical, ref_rng),
                          ref_search.sample_subnetwork(canonical, ref_rng))
        assert search._mutate(a, canonical, rng, rate=0.3) == \
            ref_search._mutate(a, canonical, ref_rng, rate=0.3)
        assert search._crossover(a, b, rng) == ref_search._crossover(a, b, ref_rng)
        assert search.sample_subnetwork(canonical, rng, min_ch=8) == \
            ref_search.sample_subnetwork(canonical, ref_rng, min_ch=8)
    # the same sub-network builds the same topology in both packages
    assert [dataclasses.astuple(l) for l in
            cnn.CNN_BUILDERS[family](widths=a, input_hw=HW).conv_specs().layers] == \
        [dataclasses.astuple(l) for l in
         ref_cnn.CNN_BUILDERS[family](widths=a, input_hw=HW).conv_specs().layers]


def test_fold_population_identical():
    rng = np.random.default_rng(2)
    pops = [[{"a": int(rng.integers(1, 4)), "b": int(rng.integers(1, 3))} for _ in range(n)]
            for n in (0, 1, 7, 30)]
    pops.append([{"a": 4, "b": 8}, {"b": 8, "a": 4}, {"a": 2, "b": 8}])   # key order
    for pop in pops:
        assert search.fold_population(pop) == ref_search.fold_population(pop)
    uniq, fan_in = search.fold_population(pops[-1])
    assert uniq == [{"a": 4, "b": 8}, {"a": 2, "b": 8}] and fan_in == [0, 0, 1]


def test_constraints_and_result_types_as_reference():
    assert [f.name for f in dataclasses.fields(search.Constraints)] == \
        [f.name for f in dataclasses.fields(ref_search.Constraints)]
    assert dataclasses.asdict(search.Constraints()) == dataclasses.asdict(ref_search.Constraints())
    assert [f.name for f in dataclasses.fields(search.SearchResult)] == \
        [f.name for f in dataclasses.fields(ref_search.SearchResult)]


# ---------------------------------------------------------------------------
# whole searches
# ---------------------------------------------------------------------------

def _tiers(mine_t, mine_i, family):
    """No budget, then budgets at the median and the lower quartile of
    what the forests predict for the canonical network's sub-networks —
    binding and feasible by construction, as the chip's tiers are."""
    canonical = cnn.CNN_BUILDERS[family](width_mult=WM, input_hw=HW).widths
    rng = np.random.default_rng(9)
    specs = [cnn.CNN_BUILDERS[family](widths=search.sample_subnetwork(canonical, rng),
                                      input_hw=HW).conv_specs() for _ in range(12)]
    g, _ = mine_t.predict_batch([(s, 16) for s in specs])
    gi, pi = mine_i.predict_batch([(s, 1) for s in specs])
    tiers = [search.Constraints(train_bs=16, infer_bs=1)]
    for q in (50, 25):
        tiers.append(search.Constraints(
            gamma_mb=float(np.percentile(g, q)), gamma_inf_mb=float(np.percentile(gi, q)),
            phi_inf_ms=float(np.percentile(pi, q)), train_bs=16, infer_bs=1))
    return tiers


def _ref_constraints(c):
    return ref_search.Constraints(**dataclasses.asdict(c))


@pytest.mark.parametrize("family", FAMILIES)
def test_search_through_a_forest_engine_identical(forests, family):
    (t, i), (rt, ri) = forests[family]
    for tier in _tiers(t, i, family):
        eng = CostEngine(ForestBackend(train=t, infer=i))
        ref_eng = ref_engine.CostEngine(ref_backends.ForestBackend(train=rt, infer=ri))
        kw = dict(population=10, iterations=6, width_mult=WM, input_hw=HW, seed=3)
        r = search.evolutionary_search(family, eng, tier, **kw)
        ref = ref_search.evolutionary_search(family, ref_eng, _ref_constraints(tier), **kw)
        assert _result(r) == _result(ref)
        assert (eng.hits, eng.misses) == (ref_eng.hits, ref_eng.misses)
        assert r.evaluations == 10 + 6 * (10 - 2) and len(r.history) == 6
        assert all(a <= b for a, b in zip(r.history, r.history[1:]))   # parents kept
        assert r.search_time_s > 0
        if np.isfinite(r.fitness):
            assert tier.gamma_mb is None or r.gamma_mb <= tier.gamma_mb
            assert tier.phi_inf_ms is None or r.phi_inf_ms <= tier.phi_inf_ms


@pytest.mark.parametrize("family", ["resnet50", "squeezenet"])
def test_search_through_forest_analytical_ensemble_identical(forests, family, tmp_path):
    """The forest answers the train stage, the analytical backend the
    inference stage the forest was not fitted for; a cached engine, so the
    second search is all hits."""
    (t, _), (rt, _) = forests[family]
    eng = CostEngine(EnsembleBackend([ForestBackend(train=t), AnalyticalBackend()]),
                     cache=EstimateCache(str(tmp_path / "mine.json")), flush_every=50)
    ref_eng = ref_engine.CostEngine(
        ref_backends.EnsembleBackend([ref_backends.ForestBackend(train=rt),
                                      ref_backends.AnalyticalBackend()]),
        cache=str(tmp_path / "ref.json"), flush_every=50)
    tier = search.Constraints(gamma_mb=float(t.predict(cnn.CNN_BUILDERS[family](
        width_mult=WM * 0.6, input_hw=HW).conv_specs(), 16)[0]), train_bs=16, infer_bs=2)
    kw = dict(population=12, iterations=5, mutate_prob=0.4, parent_frac=0.3,
              width_mult=WM, input_hw=HW, seed=11)
    for _ in range(2):
        r = search.evolutionary_search(family, eng, tier, **kw)
        ref = ref_search.evolutionary_search(family, ref_eng, _ref_constraints(tier), **kw)
        assert _result(r) == _result(ref)
        assert (eng.hits, eng.misses) == (ref_eng.hits, ref_eng.misses)
    assert eng.misses > 0 and eng.hits >= eng.misses       # the repeat hit the cache


@pytest.mark.parametrize("convention", ["tuple", "predictor", "backend"])
def test_search_backend_conventions_identical(forests, convention):
    """``evolutionary_search`` takes a (train, infer) tuple, one predictor
    or a bare backend, as the reference does."""
    (t, i), (rt, ri) = forests["squeezenet"]
    mine, ref = {"tuple": ((t, i), (rt, ri)), "predictor": (t, rt),
                 "backend": (ForestBackend(train=t, infer=i),
                             ref_backends.ForestBackend(train=rt, infer=ri))}[convention]
    tier = search.Constraints(gamma_mb=1e9, train_bs=8, infer_bs=1)
    kw = dict(population=8, iterations=3, width_mult=WM, input_hw=HW, seed=0)
    r = search.evolutionary_search("squeezenet", mine, tier, **kw)
    assert _result(r) == _result(ref_search.evolutionary_search(
        "squeezenet", ref, _ref_constraints(tier), **kw))
    assert r.fitness > 0


def test_search_scores_each_generation_in_one_call_per_stage(forests, monkeypatch):
    """Two engine calls per generation, the whole population in each, and
    duplicates folded to one query — as tests/test_engine.py holds for the
    reference."""
    (t, i), _ = forests["squeezenet"]
    calls = []

    class Spy(CostEngine):
        def estimate(self, queries):
            calls.append(len(queries))
            return super().estimate(queries)

    r = search.evolutionary_search(
        "squeezenet", Spy(ForestBackend(train=t, infer=i)),
        search.Constraints(gamma_mb=1e9, train_bs=8, infer_bs=1),
        population=12, iterations=3, width_mult=WM, input_hw=HW, seed=0)
    assert len(calls) == 8 and calls[0] == 12 and r.evaluations == 12 + 3 * 9
    calls.clear()
    monkeypatch.setattr(search, "sample_subnetwork",
                        lambda canonical, rng, min_ch=2: {g: max(min_ch, n // 2)
                                                          for g, n in canonical.items()})
    r = search.evolutionary_search(
        "squeezenet", Spy(ForestBackend(train=t, infer=i)),
        search.Constraints(gamma_mb=1e9, train_bs=8, infer_bs=1),
        population=10, iterations=0, width_mult=WM, input_hw=HW, seed=0)
    assert calls == [1, 1] and r.evaluations == 10 and r.fitness > 0


def test_infeasible_budget_gives_minus_infinity_as_reference(forests):
    (t, i), (rt, ri) = forests["resnet50"]
    tier = search.Constraints(gamma_mb=1e-6, train_bs=16, infer_bs=1)
    kw = dict(population=6, iterations=2, width_mult=WM, input_hw=HW, seed=1)
    r = search.evolutionary_search("resnet50", (t, i), tier, **kw)
    ref = ref_search.evolutionary_search("resnet50", (rt, ri), _ref_constraints(tier), **kw)
    assert r.fitness == -np.inf and _result(r) == _result(ref)
