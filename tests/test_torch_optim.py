"""The port's optimizers and gradient compression against the reference's.

``apply_updates`` runs on the same bf16 parameters, bf16 gradients and
f32 slots (drawn with numpy from a seed) in both packages, AdamW and
SGD-m, with and without clipping, at steps inside the warm-up, at its
end and on the cosine.  Tolerances: ``lr``, ``m`` and ``v`` within f32
rounding (rtol 1e-6), ``grad_norm`` within that of a sum of ~2400
squares (rtol 1e-5); the new bf16 parameters within one bf16 ulp.
Clipping scales every gradient by max_norm / ‖g‖, and the two
packages sum ‖g‖² in different orders, so a clipped gradient may round to
the other bf16 neighbour: with random gradients the slots are held to
f32 rounding plus one bf16 ulp of the gradient they read, and a second
case draws gradients as multiples of 1/16 (|g| ≤ 4), whose squared sum
both packages compute exactly, and holds the slots to f32 rounding alone.

``compress_grads`` gives exactly equal ``sent`` and ``err`` for the same
f32 inputs (leaves of at most 8 entries and 0-d leaves included), and
``compression_stats`` is equal.  Then the port's own behaviours, mirrored
from ``tests/test_optim.py``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import compression as jax_comp
from repro.optim import optimizer as jax_opt
from repro_torch.optim.compression import (
    compress_grads,
    compression_stats,
    init_error_state,
)
from repro_torch.optim.optimizer import (
    OptimizerConfig,
    apply_updates,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    init_opt_state,
)
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

SHAPES = {"embed": (64, 32), "norm": (5,), "blocks": {"w": (3, 7, 11)}, "s": ()}
BF16_ULP = 2.0 ** -8          # relative spacing of bf16 (8 significant bits)
F32 = 1e-6
NORM = 1e-5                   # a norm over the tree's ~2400 entries


def _tree(fn, shapes=SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in shapes.items()}


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _torch(tree, dtype):
    """Tensor copies: the port updates in place, and JAX may still be reading
    the numpy buffers it wrapped without copying."""
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a, np.float32)).to(dtype), tree)


def _case(seed, kind, exact_norm):
    rng = np.random.default_rng(seed)
    p = _tree(lambda s: rng.standard_normal(s).astype(ml_dtypes.bfloat16))
    if exact_norm:
        g = _tree(lambda s: (rng.integers(-64, 65, s) / 16).astype(ml_dtypes.bfloat16))
    else:
        g = _tree(lambda s: (rng.standard_normal(s) * 3).astype(ml_dtypes.bfloat16))
    slots = {"m": _tree(lambda s: (rng.standard_normal(s) * 0.1).astype(np.float32))}
    if kind == "adamw":
        slots["v"] = _tree(lambda s: (np.abs(rng.standard_normal(s)) * 0.1)
                           .astype(np.float32))
    return p, g, slots


@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
@pytest.mark.parametrize("clip", [None, 1.0, "exact"])
@pytest.mark.parametrize("step0", [0, 4, 9, 30, 60])
def test_apply_updates_matches_reference(kind, clip, step0):
    clip_norm = None if clip is None else 1.0
    kw = dict(kind=kind, lr=1e-2, clip_norm=clip_norm, warmup_steps=10, total_steps=50)
    ref_cfg, cfg = jax_opt.OptimizerConfig(**kw), OptimizerConfig(**kw)
    p, g, slots = _case(step0, kind, exact_norm=clip == "exact")

    ref_state = {"step": jnp.int32(step0), **jax.tree.map(jnp.array, slots)}
    ref_p, ref_state, ref_m = jax_opt.apply_updates(
        jax.tree.map(jnp.array, p), jax.tree.map(jnp.array, g), ref_state, ref_cfg)
    state = {"step": torch.tensor(step0, dtype=torch.int32),
             **_torch(slots, torch.float32)}
    new_p, new_state, m = apply_updates(_torch(p, torch.bfloat16),
                                        _torch(g, torch.bfloat16), state, cfg)

    assert new_state["step"].dtype == torch.int32 and int(new_state["step"]) == step0 + 1
    assert sorted(m) == sorted(ref_m)
    for key in ref_m:
        assert m[key].dtype == torch.float32
        np.testing.assert_allclose(float(m[key]), float(ref_m[key]),
                                   rtol=NORM if key == "grad_norm" else F32, atol=1e-12)
    for got, want in zip(_leaves(new_p), _leaves(ref_p)):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP, atol=0)
    # a clipped gradient may round to its other bf16 neighbour (see above)
    gmax = max(float(np.abs(np.asarray(x, np.float32)).max()) for x in _leaves(g))
    flip = BF16_ULP * gmax if clip == 1.0 else 0.0
    slack = {"m": (1 - ref_cfg.beta1 if kind == "adamw" else 1.0) * flip,
             "v": (1 - ref_cfg.beta2) * 2 * gmax * flip}
    for name in slots:
        for got, want in zip(_leaves(new_state[name]), _leaves(ref_state[name])):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32,
                                       atol=slack[name] + 1e-12)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 60, 110, 500])
def test_cosine_schedule_equals_reference(step):
    kw = dict(lr=0.3, warmup_steps=10, total_steps=110)
    got = cosine_schedule(OptimizerConfig(**kw), torch.tensor(step, dtype=torch.int32))
    want = jax_opt.cosine_schedule(jax_opt.OptimizerConfig(**kw), jnp.int32(step))
    assert got.dtype == torch.float32
    assert float(got) == float(want)


def test_clip_and_global_norm_match_reference():
    rng = np.random.default_rng(3)
    g = _tree(lambda s: rng.standard_normal(s).astype(np.float32))
    clipped, gn = clip_by_global_norm(_torch(g, torch.float32), 1.5)
    ref_clipped, ref_gn = jax_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.5)
    np.testing.assert_allclose(float(gn), float(ref_gn), rtol=NORM)
    for got, want in zip(_leaves(clipped), _leaves(ref_clipped)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2 * F32, atol=1e-12)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.5, rtol=1e-5)


def _compression_inputs(seed):
    rng = np.random.default_rng(seed)
    shapes = {"big": (40, 30), "ties": (50,), "eight": (8,), "four": (2, 2), "s": ()}
    g = _tree(lambda s: rng.standard_normal(s).astype(np.float32), shapes)
    g["ties"] = np.repeat(rng.standard_normal(5), 10).astype(np.float32)
    e = _tree(lambda s: (rng.standard_normal(s) * 0.1).astype(np.float32), shapes)
    e["ties"] = np.zeros(50, np.float32)
    return g, e


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.25, 0.9])
def test_compress_grads_equals_reference_exactly(ratio):
    g, e = _compression_inputs(int(ratio * 100))
    sent, err = compress_grads(_torch(g, torch.float32), _torch(e, torch.float32),
                               ratio=ratio)
    ref_sent, ref_err = jax_comp.compress_grads(jax.tree.map(jnp.asarray, g),
                                                jax.tree.map(jnp.asarray, e), ratio=ratio)
    for got, want in zip(_leaves(sent) + _leaves(err), _leaves(ref_sent) + _leaves(ref_err)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.count_nonzero(sent["eight"]) == 8          # small leaves pass whole
    assert compression_stats(_torch(g, torch.float32), ratio) == \
        jax_comp.compression_stats(jax.tree.map(jnp.asarray, g), ratio)


def test_compress_grads_keeps_the_gradient_dtype():
    g = {"w": torch.randn(100, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)}
    sent, err = compress_grads(g, init_error_state(g), ratio=0.1)
    assert sent["w"].dtype == torch.bfloat16 and err["w"].dtype == torch.float32
    torch.testing.assert_close(sent["w"].float() + err["w"], g["w"].float(), rtol=0, atol=0)


# -- the port's own behaviours (tests/test_optim.py) ---------------------------


def test_adamw_first_step_matches_manual():
    cfg = OptimizerConfig(kind="adamw", lr=0.1, weight_decay=0.0,
                          clip_norm=None, warmup_steps=0, total_steps=10**9)
    p = {"w": torch.ones(3)}
    st = init_opt_state(p, cfg)
    new_p, new_st, _ = apply_updates(p, {"w": torch.full((3,), 0.5)}, st, cfg)
    lr0 = float(cosine_schedule(cfg, 1))
    expect = 1.0 - lr0 * (0.5 / (0.5 + cfg.eps))
    np.testing.assert_allclose(new_p["w"].numpy(), expect, rtol=1e-5)
    assert int(new_st["step"]) == 1


def test_sgdm_accumulates_momentum():
    cfg = OptimizerConfig(kind="sgdm", lr=1.0, momentum=0.5, clip_norm=None,
                          warmup_steps=0, total_steps=10**9)
    p = [torch.zeros(2)]
    st = init_opt_state(p, cfg)
    assert "v" not in st
    g = [torch.ones(2)]
    p, st, _ = apply_updates(p, g, st, cfg)
    p, st, _ = apply_updates(p, g, st, cfg)
    np.testing.assert_allclose(st["m"][0].numpy(), 1.5)  # 0.5·1 + 1


def test_adamw_converges_on_quadratic():
    cfg = OptimizerConfig(kind="adamw", lr=0.1, weight_decay=0.0,
                          warmup_steps=0, total_steps=10**9, clip_norm=1.0)
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(8).astype(np.float32))
    p = {"w": torch.zeros(8)}
    st = init_opt_state(p, cfg)
    for _ in range(300):
        p, st, _ = apply_updates(p, {"w": p["w"] - target}, st, cfg)
    assert float((p["w"] - target).abs().max()) < 0.05


def test_topk_compression_with_error_feedback_converges():
    # stability: released error bursts are ~(1/ratio)·g, so lr·(1/ratio) < 1
    target = torch.from_numpy(np.random.default_rng(1).standard_normal(64).astype(np.float32))
    p = {"w": torch.zeros(64)}
    err = init_error_state(p)
    for _ in range(600):
        sent, err = compress_grads({"w": p["w"] - target}, err, ratio=0.1)
        p = {"w": p["w"] - 0.05 * sent["w"]}
    assert float((p["w"] - target).abs().max()) < 0.05


def test_unknown_optimizer_kind_raises():
    cfg = OptimizerConfig(kind="lion")
    p = {"w": torch.zeros(2)}
    with pytest.raises(ValueError, match="lion"):
        apply_updates(p, p, init_opt_state(p, cfg), cfg)
