"""Port of the CNN zoo against the reference, for all seven families at a
small width and input size: the same seed gives the same parameter dict
and the same ``conv_specs()``; from those parameters and one numpy batch,
logits and loss gradients agree.

Logits, loss and gradients are held against the exact (float64)
reference result, at a tolerance set by the reference's own f32 error
(see ``test_logits_and_grads_match``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as ref_cnn
from repro_torch.convert import cnn_params_from_numpy, cnn_params_to_numpy
from repro_torch.models import cnn
from tests._torch_host import float64_jit, port_host_share  # noqa: F401 (autouse)


FAMILIES = sorted(cnn.CNN_BUILDERS)
WIDTH, HW, BS = 0.125, 32, 8


def _models(family, **kw):
    kw = kw or dict(width_mult=WIDTH, input_hw=HW)
    return cnn.CNN_BUILDERS[family](**kw), ref_cnn.CNN_BUILDERS[family](**kw)


def _spec_tuple(spec):
    return spec.name, tuple(dataclasses.astuple(layer) for layer in spec.layers)


def _flat(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_builders_and_widths_match():
    assert sorted(ref_cnn.CNN_BUILDERS) == FAMILIES
    for family in FAMILIES:
        assert cnn.canonical_widths(family) == ref_cnn.canonical_widths(family)
        assert cnn.canonical_widths(family, 0.3) == ref_cnn.canonical_widths(family, 0.3)


@pytest.mark.parametrize("family", FAMILIES)
def test_same_seed_same_params_and_specs(family):
    mine, ref = _models(family)
    assert _spec_tuple(mine.conv_specs()) == _spec_tuple(ref.conv_specs())
    assert mine.num_params() == ref.num_params()
    assert mine.widths == ref.widths
    a, b = _flat(mine.init(7)), _flat(ref.init(7))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("family", ["resnet50", "alexnet"])
def test_full_width_specs_match(family):
    """At the full-width, 32×32 configuration the profiled cell uses."""
    mine, ref = _models(family, width_mult=1.0, input_hw=32)
    assert _spec_tuple(mine.conv_specs()) == _spec_tuple(ref.conv_specs())


def test_params_round_trip_and_copy():
    mine, _ = _models("resnet18")
    init = mine.init(0)
    params = cnn_params_from_numpy(init, device="cpu")
    with torch.no_grad():
        params["0"]["w"].add_(1.0)           # the numpy arrays are not shared
    back = cnn_params_to_numpy(params)
    assert not np.array_equal(back["0"]["w"], init["0"]["w"])
    back["0"]["w"] -= 1.0
    for (ka, a), (kb, b) in zip(_flat(back), _flat(init)):
        assert ka == kb and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(BS, HW, HW, 3)).astype(np.float32)
    y = rng.integers(0, 100, size=(BS,)).astype(np.int32)
    return x, y


def _jax_loss_and_grads(ref, params, x, y, jit=jax.jit):
    """(loss, logits, grads) of the reference, as numpy float64."""

    def loss_fn(p):
        logits = ref.apply(p, x)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1)), logits

    (loss, logits), grads = jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return (np.float64(loss), np.asarray(logits, np.float64),
            [np.asarray(g, np.float64) for _, g in _flat(grads)])


def _torch_loss_and_grads(model, params, x, y):
    leaves = [leaf for _, leaf in _flat(params)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    logits = model.apply(params, torch.from_numpy(x))
    logp = torch.log_softmax(logits, -1)
    loss = -logp.gather(1, torch.from_numpy(y).long()[:, None]).mean()
    grads = torch.autograd.grad(loss, leaves)
    return (np.float64(loss.item()), logits.detach().double().numpy(),
            [g.double().numpy() for g in grads])


@pytest.mark.parametrize("family", FAMILIES)
def test_logits_and_grads_match(family):
    """From the same parameters and batch, the port's f32 logits, loss and
    gradients are as close to the exact result as the reference's f32 ones.

    The exact result is the reference run in float64.  Batch-statistics
    BatchNorm over few values is ill-conditioned in the deeper families
    (MobileNetV2, MnasNet, ResNet-50): there the reference's own f32
    gradients are up to ~2% of the largest gradient away from the float64
    ones, so a fixed atol against the f32 reference would say nothing.
    Tolerance, per compared array, in the Euclidean norm of the flattened
    array: ‖port − exact‖ ≤ 4·‖ref_f32 − exact‖ + 2e-4·‖exact‖ + 1e-6.
    The factor 4 covers the spread between two summation orders' rounding
    errors; 2e-4 of the array's norm (the reference kernel tests' f32
    tolerance) is a floor for arrays that the reference happens to round
    luckily.  A norm, not a maximum: one ill-conditioned element would
    make a maximum swing by several times between two runs.
    """
    mine, ref = _models(family)
    init = ref.init(0)
    x, y = _batch()
    with jax.enable_x64(True):
        exact = _jax_loss_and_grads(
            ref, jax.tree.map(lambda a: a.astype(np.float64), init),
            x.astype(np.float64), y, jit=float64_jit)
    ref32 = _jax_loss_and_grads(ref, init, x, y)
    port = _torch_loss_and_grads(mine, cnn_params_from_numpy(init, device="cpu"), x, y)
    names = ["loss", "logits"] + [jax.tree_util.keystr(k) for k, _ in _flat(init)]
    flat = [list(v[:2]) + v[2] for v in (exact, ref32, port)]
    assert len(flat[2]) == len(names)
    for name, e, r, p in zip(names, *flat):
        assert np.shape(p) == np.shape(e), name
        dist = lambda a: np.linalg.norm(np.ravel(a - e))  # noqa: E731
        tol = 4 * dist(r) + 2e-4 * np.linalg.norm(np.ravel(e)) + 1e-6
        assert dist(p) <= tol, (name, dist(p), tol)


def test_pools_match_reduce_window():
    """Max pool pads with -inf; average pool divides by the in-image count."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 7, 5)).astype(np.float32)
    for node in (cnn.Pool("max", 3, 1, 1), cnn.Pool("avg", 3, 2, 1),
                 cnn.Pool("max", 2, 2), cnn.GlobalAvgPool()):
        ref_node = getattr(ref_cnn, type(node).__name__)(**dataclasses.asdict(node))
        np.testing.assert_allclose(node.apply({}, torch.from_numpy(x)).numpy(),
                                   np.asarray(ref_node.apply({}, x)), rtol=1e-6, atol=1e-6)
