"""The port's capacity-dispatch MoE against the reference's, on layer 0
of reduced qwen3-moe-30b-a3b (4 experts, top-2, d_ff 128) with the same
f32 parameters and the same numpy inputs.

Routing is held exactly: the top-k expert ids, every (token, expert)
pair's route (sorted expert, capacity slot, sort order) and so which
pairs are kept and which dropped.  The outputs are held to 1e-5 (f32
products summed in other orders), and so is the load-balance loss
relative to its value: it averages f32 router probabilities that the two
packages' products give to within an ulp, so it is not bit-exact.  Each
case runs with drops (the configured capacity factor 1.25 and inputs
leaning towards one expert, so the case asserts that some pair is
dropped) and without (factor 8), with one token group (B = 1) and with
four (B = 4: ``gcd(B, 32)`` groups with tuning off).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as TL
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

F32 = 1e-5
ARCH = "qwen3-moe-30b-a3b"


@pytest.fixture(autouse=True)
def _pinned_tilings(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


@pytest.fixture(scope="module")
def moe():
    jcfg, tcfg = jax_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    tree = JT.init_params(jcfg, 0)
    jp = {k: jnp.asarray(np.asarray(v, np.float32)[0])
          for k, v in tree["blocks"]["sub0"]["moe"].items()}
    tp = params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
    return jcfg, tcfg, jp, tp.blocks[0].moe


def _x(p, B, S, lean: float, seed=5):
    """Unit-normal tokens plus ``lean`` times the direction that raises
    expert 0's router logit: with lean > 0 expert 0 is over-subscribed."""
    rng = np.random.default_rng(seed)
    router = np.asarray(p["router"])
    d = router[:, 0] - router[:, 1:].mean(axis=1)
    x = rng.standard_normal((B, S, router.shape[0])) + lean * d / np.linalg.norm(d)
    return x.astype(np.float32)


def _jax_route(x, p, cfg, G, C):
    """The reference's routing of ``moe_block`` up to the dispatch:
    (ids, sorted_e, dest_c, sort_idx)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token

    def route(x, router):
        xg = x.reshape(G, (B // G) * S, D)
        probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xg, router), axis=-1)
        gates, ids = jax.lax.top_k(probs, K)
        _, rt = jax.vmap(lambda xt, g, i: JL._moe_dispatch_group(
            xt, g, i, None, E, K, C))(xg, gates, ids)
        return ids, rt

    ids, rt = jax.jit(route)(jnp.asarray(x), p["router"])
    return [np.asarray(a) for a in (ids, *rt)]


def _port_route(x, p, cfg, G, C):
    B, S, D = x.shape
    xg = torch.from_numpy(x).reshape(G, (B // G) * S, D)
    probs = torch.softmax(xg @ p.router, dim=-1)
    _, ids = TL._top_k(probs, cfg.experts_per_token)
    _, rt = TL._moe_dispatch_group(xg, ids, cfg.n_experts,
                                   cfg.experts_per_token, C)
    return [t.numpy() for t in (ids, *rt)]


@pytest.mark.parametrize("factor", [None, 8.0], ids=["drops", "no-drops"])
@pytest.mark.parametrize("B", [1, 4], ids=["G1", "G4"])
def test_moe_block_matches_reference(moe, B, factor):
    jcfg, tcfg, jp, tp = moe
    if factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=factor)
    S = 24
    x = _x(jp, B, S, lean=0.0 if factor else 3.0)
    G, cf = TL._tuned_moe_dispatch(B, S, tcfg, torch.float32)
    assert (G, cf) == JL._tuned_moe_dispatch(B, S, jcfg, jnp.float32)
    assert G == np.gcd(B, 32)
    C = TL.moe_capacity((B // G) * S, tcfg.n_experts, tcfg.experts_per_token, cf)
    assert C == JL.moe_capacity((B // G) * S, jcfg.n_experts,
                                jcfg.experts_per_token, cf)

    want = _jax_route(x, jp, jcfg, G, C)
    got = _port_route(x, tp, tcfg, G, C)
    for name, g, w in zip(("ids", "sorted_e", "dest_c", "sort_idx"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    dropped = int((got[2] == C).sum())
    if factor is None:
        assert dropped > 0, "the leaning inputs should overflow expert 0"
    else:
        assert dropped == 0

    j_out, j_aux = jax.jit(lambda x, p: JL.moe_block(x, p, jcfg))(jnp.asarray(x), jp)
    t_out, t_aux = TL.moe_block(torch.from_numpy(x), tp, tcfg)
    assert t_out.shape == (B, S, tcfg.d_model) and t_aux.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0, atol=F32)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=F32)


def test_top_k_keeps_the_lower_index_on_a_tie():
    """``lax.top_k`` ranks equal values by index; so does the port."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    _, j_ids = jax.lax.top_k(jnp.asarray(probs), 2)
    _, t_ids = TL._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_ids.numpy(), [[0, 1], [1, 3], [0, 2]])


def test_load_balance_loss_and_capacity_match_reference():
    rng = np.random.default_rng(2)
    probs = rng.dirichlet(np.ones(8), size=40).astype(np.float32)
    ids = rng.integers(0, 8, (40, 2))
    want = JL._load_balance_loss(jnp.asarray(probs), jnp.asarray(ids), 8)
    got = TL._load_balance_loss(torch.from_numpy(probs), torch.from_numpy(ids), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for tokens, E, K, f in [(1, 128, 8, 1.25), (24, 4, 2, 1.25), (2048, 128, 8, 1.25),
                            (96, 4, 2, 8.0), (7, 16, 1, 1.0)]:
        assert TL.moe_capacity(tokens, E, K, f) == JL.moe_capacity(tokens, E, K, f)


def test_moe_block_carries_gradients(moe):
    """The port's block has a backward (the dispatch gathers, the combine
    gathers back): the input and every expert weight get a finite
    gradient, the router through the gates and the aux loss."""
    _, tcfg, jp, tp = moe
    x = torch.from_numpy(_x(jp, 2, 8, lean=0.0)).requires_grad_(True)
    for p in tp.parameters():
        p.requires_grad_(True)
    try:
        out, aux = TL.moe_block(x, tp, tcfg)
        (out.square().mean() + aux).backward()
        for t in (x, *tp.parameters()):
            assert t.grad is not None and torch.isfinite(t.grad).all()
            assert t.grad.abs().max() > 0
    finally:
        for p in tp.parameters():
            p.requires_grad_(False)
            p.grad = None
