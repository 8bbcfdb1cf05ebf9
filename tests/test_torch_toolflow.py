"""Port of the paper's CNN toolflow against the reference: pruning,
the profiled training step, the CPU memory stand-in, the analytical
features, the datapoint cache and the random-forest predictor.

Framework-free results (pruned widths, features, datapoints, forest
predictions, saved predictors) are held exactly.  One training step is
held against the reference at the tolerance ``tests/test_torch_cnn.py``
states for gradients, against the reference run in float64.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import dataset as ref_dataset
from repro.core import features as ref_features
from repro.core import predictor as ref_predictor
from repro.core import pruning as ref_pruning
from repro.core.profiler import make_train_step as ref_make_train_step
from repro.models import cnn as ref_cnn
from repro_torch.convert import cnn_params_from_numpy, cnn_params_to_numpy
from repro_torch.core import dataset, features, predictor, pruning
from repro_torch.core.profiler import (make_infer_fn, make_train_step,
                                       profile_inference, profile_training)
from repro_torch.models import cnn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: these CPU-sized cases gain
    little from more, and other test files run timed steps beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAMILIES = sorted(cnn.CNN_BUILDERS)
FIXTURE = "benchmarks/cache/cnn_profile.json"


def _fixture_path():
    from pathlib import Path
    return str(Path(__file__).resolve().parents[1] / FIXTURE)


# ---------------------------------------------------------------------------
# pruning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("level", [0.3, 0.7])
@pytest.mark.parametrize("strategy", pruning.PRUNE_STRATEGIES)
@pytest.mark.parametrize("family", FAMILIES)
def test_pruned_widths_identical(family, strategy, level, seed):
    assert pruning.PRUNE_STRATEGIES == ref_pruning.PRUNE_STRATEGIES
    base = cnn.CNN_BUILDERS[family](width_mult=0.25, input_hw=16)
    ref_base = ref_cnn.CNN_BUILDERS[family](width_mult=0.25, input_hw=16)
    assert base.widths == ref_base.widths
    scores = ref_scores = None
    if strategy == "l1":
        scores, ref_scores = pruning.l1_scores(base, seed), ref_pruning.l1_scores(ref_base, seed)
        assert scores.keys() == ref_scores.keys()
        assert all(np.array_equal(scores[g], ref_scores[g]) for g in scores)
    mine = pruning.prune_widths(base.widths, level, strategy,
                                np.random.default_rng(seed), scores=scores)
    ref = ref_pruning.prune_widths(ref_base.widths, level, strategy,
                                   np.random.default_rng(seed), scores=ref_scores)
    assert mine == ref
    m = pruning.pruned_model(family, level, strategy, seed, width_mult=0.25, input_hw=16)
    r = ref_pruning.pruned_model(family, level, strategy, seed, width_mult=0.25, input_hw=16)
    assert (m.name, m.widths, m.input_hw) == (r.name, r.widths, r.input_hw)


@pytest.mark.parametrize("family", FAMILIES)
def test_random_profile_widths_identical(family):
    widths = cnn.canonical_widths(family, 0.5)
    for seed, level in ((0, 0.4), (5, 0.8)):
        assert (pruning.random_profile_widths(widths, level, np.random.default_rng(seed))
                == ref_pruning.random_profile_widths(widths, level,
                                                     np.random.default_rng(seed)))


@pytest.mark.parametrize("strategy", ["random", "l1"])
@pytest.mark.parametrize("family", FAMILIES)
def test_grid_topologies_identical(family, strategy):
    """The grid's own pruning (seed + level) gives the reference's widths."""
    spec = dataset.GridSpec(family, (0.0, 0.4), strategy)
    ref_spec = ref_dataset.GridSpec(family, (0.0, 0.4), strategy)
    for level in spec.levels:
        m, r = dataset._build_pruned(spec, level), ref_dataset._build_pruned(ref_spec, level)
        assert (m.name, m.widths) == (r.name, r.widths)


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

def _specs(family):
    mine, ref = [], []
    for level in (0.0, 0.5):
        m = pruning.pruned_model(family, level, "random", 1, width_mult=0.25, input_hw=16)
        r = ref_pruning.pruned_model(family, level, "random", 1, width_mult=0.25, input_hw=16)
        mine.append(m.conv_specs())
        ref.append(r.conv_specs())
    return mine, ref


@pytest.mark.parametrize("family", FAMILIES)
def test_features_exact(family):
    mine, ref = _specs(family)
    for s, r in zip(mine, ref):
        for bs in (1, 2, 32, 256):
            a = features.network_features(s, bs)
            b = ref_features.network_features(r, bs)
            assert a.dtype == b.dtype and np.array_equal(a, b)
    pairs = [(s, bs) for s in mine for bs in (2, 64)]
    ref_pairs = [(r, bs) for r in ref for bs in (2, 64)]
    assert np.array_equal(features.feature_matrix(pairs),
                          ref_features.feature_matrix(ref_pairs))
    assert np.array_equal(features.batch_network_features(pairs),
                          ref_features.batch_network_features(ref_pairs))
    assert features.FEATURE_NAMES == ref_features.FEATURE_NAMES


# ---------------------------------------------------------------------------
# datapoints and the predictor on the reference's fixture (read-only)
# ---------------------------------------------------------------------------

def _fixture_points():
    with open(_fixture_path()) as f:
        raw = json.load(f)
    return ([dataset.Datapoint(**d) for d in raw.values()],
            [ref_dataset.Datapoint(**d) for d in raw.values()], list(raw))


def test_fixture_datapoints_and_targets():
    mine, ref, keys = _fixture_points()
    assert [dp.key for dp in mine] == [dp.key for dp in ref] == keys
    assert [dataclasses.asdict(a) for a in mine] == [dataclasses.asdict(b) for b in ref]
    for a, b in zip(dataset.features_targets(mine), ref_dataset.features_targets(ref)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_dataset_cache_reads_fixture_without_writing(tmp_path):
    import shutil

    path = tmp_path / "cnn_profile.json"
    shutil.copy(_fixture_path(), path)
    before = path.read_bytes()
    cache, ref_cache = dataset.DatasetCache(str(path)), ref_dataset.DatasetCache(str(path))
    mine, _, keys = _fixture_points()
    assert len(cache) == len(ref_cache) == len(keys)
    assert all(cache.get(k) == dp for k, dp in zip(keys, mine))
    assert path.read_bytes() == before


def _fitted(points, module, seed=3):
    return module.Perf4Sight(n_estimators=20, seed=seed).fit(points)


def test_predictor_predicts_exactly_what_the_reference_predicts():
    mine, ref, _ = _fixture_points()
    pm, pr = _fitted(mine, predictor), _fitted(ref, ref_predictor)
    assert pm.content_hash() == pr.content_hash()
    X, _, _ = dataset.features_targets(mine)
    for a, b in zip(pm.predict_features(X), pr.predict_features(X)):
        assert np.array_equal(a, b)
    specs, ref_specs = _specs("resnet50")
    pairs = [(s, bs) for s in specs for bs in (2, 8, 64)]
    ref_pairs = [(s, bs) for s in ref_specs for bs in (2, 8, 64)]
    for a, b in zip(pm.predict_batch(pairs), pr.predict_batch(ref_pairs)):
        assert np.array_equal(a, b)
    assert pm.predict(specs[1], 16) == pr.predict(ref_specs[1], 16)
    assert pm.admit(specs[1], 16, gamma_budget_mb=1.0) == pr.admit(ref_specs[1], 16,
                                                                     gamma_budget_mb=1.0)
    rm, rr = pm.evaluate(mine), pr.evaluate(ref)
    assert (rm.gamma_mape, rm.phi_mape, rm.n) == (rr.gamma_mape, rr.phi_mape, rr.n)
    assert predictor.mape(np.array([1.0, 3.0]), np.array([2.0, 2.0])) == 0.5
    forest = predictor.Perf4Sight(n_estimators=10, seed=1, hybrid=False).fit(mine)
    ref_forest = ref_predictor.Perf4Sight(n_estimators=10, seed=1, hybrid=False).fit(ref)
    assert np.array_equal(forest.predict_features(X)[1], ref_forest.predict_features(X)[1])


@pytest.mark.parametrize("hybrid", [True, False])
@pytest.mark.parametrize("ext", ["npz", "json"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_saved_predictor_loads_in_the_other_package(tmp_path, writer, ext, hybrid):
    mine, ref, _ = _fixture_points()
    pm = predictor.Perf4Sight(n_estimators=10, seed=2, hybrid=hybrid).fit(mine)
    pr = ref_predictor.Perf4Sight(n_estimators=10, seed=2, hybrid=hybrid).fit(ref)
    path = str(tmp_path / f"p4s.{ext}")
    if writer == "port":
        pm.save(path)
        loaded, other = ref_predictor.Perf4Sight.load(path), pm
    else:
        pr.save(path)
        loaded, other = predictor.Perf4Sight.load(path), pr
    X, _, _ = dataset.features_targets(mine)
    for a, b in zip(loaded.predict_features(X), other.predict_features(X)):
        assert np.array_equal(a, b)
    assert loaded.content_hash() == other.content_hash()


# ---------------------------------------------------------------------------
# the profiled step and the profiler
# ---------------------------------------------------------------------------

def _step_case(family, bs=8, hw=32):
    mine = cnn.CNN_BUILDERS[family](width_mult=0.125, input_hw=hw)
    ref = ref_cnn.CNN_BUILDERS[family](width_mult=0.125, input_hw=hw)
    init = ref.init(0)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(bs, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, 100, size=(bs,)).astype(np.int32)
    mom = jax.tree.map(lambda a: np.asarray(rng.normal(size=a.shape) * 0.1, np.float32), init)
    return mine, ref, init, mom, x, y


def _flat(tree):
    return [np.asarray(leaf, np.float64) for leaf in jax.tree_util.tree_leaves(tree)]


def _close_to_exact(port, ref32, exact) -> bool:
    """The tolerance of ``tests/test_torch_cnn.py``: the port's distance
    to the float64 result is at most 4× the reference's f32 distance, plus
    2e-4 of the array's norm."""
    def dist(a):
        return np.linalg.norm(np.ravel(a - exact))
    return dist(port) <= 4 * dist(ref32) + 2e-4 * np.linalg.norm(np.ravel(exact)) + 1e-6


@pytest.mark.parametrize("family", ["resnet50", "mobilenetv2"])
def test_train_step_matches_reference(family):
    """One SGD-momentum step from the same parameters, momentum and batch:
    parameters, momentum and loss agree with the reference's step.  As for
    gradients, the port is held against the reference run in float64 at
    4·(the reference's own f32 error) + 2e-4 of each array's norm."""
    mine, ref, init, mom, x, y = _step_case(family)
    ref_step = jax.jit(ref_make_train_step(ref))
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        p64, m64, l64 = ref_step(to64(init), to64(mom), x.astype(np.float64), y)
        exact = _flat(p64) + _flat(m64) + [np.float64(l64)]
    p32, m32, l32 = ref_step(init, mom, x, y)
    ref32 = _flat(p32) + _flat(m32) + [np.float64(l32)]

    params = cnn_params_from_numpy(init, device="cpu")
    momentum = cnn_params_from_numpy(mom, device="cpu")
    new_p, new_m, loss = make_train_step(mine)(params, momentum,
                                               torch.from_numpy(x), torch.from_numpy(y))
    assert new_p is params and new_m is momentum          # updated in place
    port = (_flat(cnn_params_to_numpy(new_p)) + _flat(cnn_params_to_numpy(new_m))
            + [np.float64(loss.item())])
    assert len(port) == len(exact) == len(ref32)
    for e, r, p in zip(exact, ref32, port):
        assert _close_to_exact(p, r, e)


def test_infer_fn_is_apply_without_grad():
    mine, _, init, _, x, _ = _step_case("squeezenet", bs=2, hw=16)
    params = cnn_params_from_numpy(init, device="cpu")
    out = make_infer_fn(mine)(params, torch.from_numpy(x))
    assert not out.requires_grad and out.shape == (2, 100)
    with torch.no_grad():
        assert torch.equal(out, mine.apply(params, torch.from_numpy(x)))


def test_cpu_gamma_grows_with_batch_and_width():
    """On the CPU Γ is the deterministic stand-in of the profiler's
    docstring: it grows with batch size and width, ``arg`` is exactly
    parameters + momentum + batch, and flops are linear in batch size."""
    res = {}
    for wm in (0.125, 0.25):
        model = cnn.build_resnet18(width_mult=wm, input_hw=16)
        n_params = sum(a.size for a in jax.tree_util.tree_leaves(model.init(0)))
        for bs in (2, 8):
            r = profile_training(model, bs, repeats=1, warmup=0, device="cpu")
            res[wm, bs] = r
            batch_bytes = bs * 16 * 16 * 3 * 4 + bs * 4
            assert r.arg_mb * 1e6 == pytest.approx(2 * 4 * n_params + batch_bytes)
            assert r.gamma_mb == pytest.approx(r.arg_mb + r.temp_mb + r.out_mb)
            assert r.temp_mb * 1e6 > 4 * n_params          # grads + saved tensors
            assert r.out_mb * 1e6 == 4 and r.code_mb == 0.0
            assert r.phi_ms > 0 and r.compile_s > 0
    for wm in (0.125, 0.25):
        assert res[wm, 8].gamma_mb > res[wm, 2].gamma_mb
        assert res[wm, 8].flops == pytest.approx(4 * res[wm, 2].flops)
    for bs in (2, 8):
        assert res[0.25, bs].gamma_mb > res[0.125, bs].gamma_mb
    again = profile_training(cnn.build_resnet18(width_mult=0.125, input_hw=16), 2,
                             repeats=1, warmup=0, device="cpu")
    assert again.gamma_mb == res[0.125, 2].gamma_mb


def test_profile_inference_on_cpu():
    model = cnn.build_mobilenetv2(width_mult=0.125, input_hw=16)
    r = profile_inference(model, 4, repeats=1, warmup=0, device="cpu")
    n_params = sum(a.size for a in jax.tree_util.tree_leaves(model.init(0)))
    assert r.arg_mb * 1e6 == pytest.approx(4 * n_params + 4 * 16 * 16 * 3 * 4)
    assert r.out_mb * 1e6 == 4 * 100 * 4 and r.temp_mb == 0.0
    assert r.gamma_mb == pytest.approx(r.arg_mb + r.out_mb)
    assert r.phi_ms > 0 and r.flops > 0


def test_collect_grid_on_cpu(tmp_path):
    """A tiny grid profiled on the CPU: keys and features equal the
    reference's for the same grid, the cache reloads in both packages, and
    a second pass is served from the cache."""
    path = str(tmp_path / "port_profile.json")
    spec = dataset.GridSpec("squeezenet", (0.0, 0.5), "l1", (2, 4))
    cache = dataset.DatasetCache(path)
    dps = dataset.collect_grid(spec, cache, repeats=1, warmup=0, device="cpu")
    assert len(dps) == 4 and len(cache) == 4
    ref_spec = ref_dataset.GridSpec("squeezenet", (0.0, 0.5), "l1", (2, 4))
    for dp, (level, bs) in zip(dps, [(lv, b) for lv in spec.levels for b in spec.batch_sizes]):
        ref_model = ref_dataset._build_pruned(ref_spec, level)
        want = ref_features.network_features(ref_model.conv_specs(), bs)
        assert dp.features == [float(v) for v in want]
        assert dp.gamma_mb > 0 and dp.phi_ms > 0
        assert (dp.level, dp.bs, dp.strategy) == (level, bs, "l1")
    ref_cache = ref_dataset.DatasetCache(path)
    assert [ref_cache.get(dp.key).features for dp in dps] == [dp.features for dp in dps]
    again = dataset.collect_grid(spec, dataset.DatasetCache(path), device="cpu")
    assert [dataclasses.asdict(a) for a in again] == [dataclasses.asdict(b) for b in dps]
    X, g, p = dataset.features_targets(dps)
    assert X.shape == (4, len(features.FEATURE_NAMES)) and (g > 0).all() and (p > 0).all()


def test_grid_levels_and_batch_sizes_match():
    for name in ("PAPER_TRAIN_LEVELS", "PAPER_ALL_LEVELS", "DEFAULT_TRAIN_LEVELS",
                 "DEFAULT_TEST_LEVELS", "DEFAULT_BATCH_SIZES", "PAPER_BATCH_SIZES"):
        assert getattr(dataset, name) == getattr(ref_dataset, name)
    assert dataset.paper_test_levels() == ref_dataset.paper_test_levels()
    for full in (False, True):
        assert ([dataclasses.astuple(g) for g in dataset.default_grid("resnet50", full=full)]
                == [dataclasses.astuple(g) for g in ref_dataset.default_grid("resnet50",
                                                                             full=full)])


def test_reduced_resnet50_step_conditioning():
    """Pins the gradient tolerance that ``chip_smoke.py`` holds the card's
    step to: at its configuration (ResNet-50 width 0.25, 16x16, bs 8,
    seed 0, the batch drawn from ``default_rng(0)``) the reference's own f32
    gradients are about 2.5e-2 (relative, Euclidean norm over all arrays;
    2.485e-2 on the test host) away from its float64 gradients, and the
    port's CPU f32 gradients no farther."""
    ref = ref_cnn.build_resnet50(width_mult=0.25, input_hw=16)
    mine = cnn.build_resnet50(width_mult=0.25, input_hw=16)
    init = ref.init(0)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 100, size=(8,)).astype(np.int32)

    def jax_grads(params, xx):
        def loss(p):
            logp = jax.nn.log_softmax(ref.apply(p, xx))
            return -jax.numpy.mean(jax.numpy.take_along_axis(logp, y[:, None], axis=1))
        return _flat(jax.jit(jax.grad(loss))(params))

    with jax.enable_x64(True):
        exact = jax_grads(jax.tree.map(lambda a: a.astype(np.float64), init),
                          x.astype(np.float64))
    params = cnn_params_from_numpy(init, device="cpu")
    leaves = [leaf for _, leaf in jax.tree_util.tree_leaves_with_path(params)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    logp = torch.log_softmax(mine.apply(params, torch.from_numpy(x)), -1)
    loss = -logp.gather(1, torch.from_numpy(y).long()[:, None]).mean()
    port = [g.double().numpy() for g in torch.autograd.grad(loss, leaves)]

    def rel(grads):
        return np.sqrt(sum(np.linalg.norm(a - e) ** 2 for a, e in zip(grads, exact))
                       / sum(np.linalg.norm(e) ** 2 for e in exact))

    ref_err = rel(jax_grads(init, x))
    assert 2e-2 < ref_err < 3e-2
    assert rel(port) <= ref_err
