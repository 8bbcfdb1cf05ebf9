"""The port's reduced qwen3-4b (2 layers, d_model 128, vocab 512) against
the reference with the same parameters (cast to f32, exact from bf16):
``forward`` logits, ``prefill`` logits and cache, ``decode_step`` over a
dense cache and over a paged pool, plus seed-identical ``init_params``
and the converter's round trip.

Tolerance: 1e-5 where everything stays f32.  Where K/V sit in a bf16
cache, both packages round the same f32 values to bf16 and f32 noise can
flip one rounding to the other neighbour: cache entries are held to one
bf16 ulp (rtol 2**-7) and logits of magnitude ~1 to atol 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import transformer as JT
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models import transformer as TT

F32 = 1e-5
KV_BF16 = 2e-3


@pytest.fixture(autouse=True)
def _pinned_tilings(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    # the reference's paged decode as its kernel computes it (f32
    # probabilities), not its CPU gather fallback (bf16 probabilities)
    monkeypatch.setenv("REPRO_PAGED_DECODE", "interpret")


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config("qwen3-4b", reduced=True)
    tcfg = get_config("qwen3-4b", reduced=True)
    tree = JT.init_params(jcfg, 0)
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)), tree)
    tp = params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
    return jcfg, tcfg, tree, jp, tp


def _close(t, j, atol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=0, atol=atol)


def _close_kv(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=2.0**-7, atol=1e-6)


def _tokens(B, S, seed=0):
    a = np.random.default_rng(seed).integers(2, 512, (B, S)).astype(np.int32)
    return jnp.asarray(a), torch.from_numpy(a)


def test_init_params_seed_identical():
    """``init_params(cfg, 0)`` draws the reference's values bit for bit."""
    cfg = get_config("qwen3-4b", reduced=True)
    tree = JT.init_params(jax_config("qwen3-4b", reduced=True), 0)
    mine = params_to_numpy(TT.init_params(cfg, 0, device="cpu"), cfg)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(TT.param_leaves(cfg))
    for path, leaf in leaves:
        got = mine
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, np.asarray(leaf, np.float32),
                                      err_msg=jax.tree_util.keystr(path))


def test_converter_round_trip(model):
    _, tcfg, tree, _, tp = model
    back = params_to_numpy(tp, tcfg)
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, np.asarray(leaf, np.float32))


def test_forward_logits(model):
    jcfg, tcfg, _, jp, tp = model
    jt, tt = _tokens(2, 24)
    t, _ = TT.forward(tp, {"tokens": tt}, tcfg)
    j, _ = JT.forward(jp, {"tokens": jt}, jcfg)
    assert t.shape == (2, 24, jcfg.padded_vocab())
    _close(t, j, F32)


def test_prefill_and_dense_decode(model):
    """Ragged left-padded prefill into a dense cache, then lockstep decode
    steps (scalar cache_len with per-row offsets) over it."""
    jcfg, tcfg, _, jp, tp = model
    jt, tt = _tokens(2, 12)
    pad = np.array([3, 0], np.int32)
    L = 32
    t = TT.prefill(tp, {"tokens": tt, "pos_offset": torch.from_numpy(pad)},
                   tcfg, max_len=L)
    j = jax.jit(lambda p, b: JT.prefill(p, b, jcfg, max_len=L))(
        jp, {"tokens": jt, "pos_offset": jnp.asarray(pad)})
    _close(t["logits"], j["logits"], KV_BF16)
    for name in ("k", "v"):
        _close_kv(t["cache"]["sub0"][name], j["cache"]["sub0"][name])
    tc, jc, cl = t["cache"], j["cache"], 12
    step = jax.jit(lambda p, c, b: JT.decode_step(p, c, b, jcfg))
    for i in range(3):
        jt, tt = _tokens(2, 1, seed=10 + i)
        tl, tc = TT.decode_step(tp, tc, {
            "tokens": tt, "cache_len": cl, "pos_offset": torch.from_numpy(pad)},
            tcfg)
        jl, jc = step(jp, jc, {"tokens": jt, "cache_len": jnp.int32(cl),
                               "pos_offset": jnp.asarray(pad)})
        _close(tl, jl, KV_BF16)
        cl += 1
    for name in ("k", "v"):
        _close_kv(tc["sub0"][name], jc["sub0"][name])


def test_paged_decode(model):
    """A chunked-prefill chunk (S > 1) and then single-token steps over a
    paged pool at ragged per-row fills, idle slot included."""
    jcfg, tcfg, _, jp, tp = model
    n_blocks, bs = 9, 8
    tpool = TT.init_paged_cache(tcfg, n_blocks, bs, device="cpu")
    jpool = JT.init_paged_cache(jcfg, n_blocks, bs)
    step = jax.jit(lambda p, c, b: JT.decode_step(p, c, b, jcfg))

    def both_step(tokens, cache_len, table):
        nonlocal tpool, jpool
        jt, tt = tokens
        tl, tpool = TT.decode_step(tp, tpool, {
            "tokens": tt, "cache_len": torch.from_numpy(cache_len),
            "block_table": torch.from_numpy(table)}, tcfg)
        jl, jpool = step(jp, jpool, {
            "tokens": jt, "cache_len": jnp.asarray(cache_len),
            "block_table": jnp.asarray(table)})
        _close(tl, jl, KV_BF16)

    # row 0 prefills 13 tokens as one chunk (right-padded to 16)
    both_step(_tokens(1, 16, seed=3), np.array([0], np.int32),
              np.array([[1, 2]], np.int32))
    # rows 0 and 2 decode; row 1 is idle (cache_len 0, scratch table row)
    table = np.array([[1, 2, 3], [0, 0, 0], [4, 5, 6]], np.int32)
    cl = np.array([13, 0, 7], np.int32)
    for i in range(3):
        both_step(_tokens(3, 1, seed=20 + i), cl, table)
        cl = cl + np.array([1, 0, 1], np.int32)
    for name in ("k_pool", "v_pool"):   # scratch block 0 aside
        _close_kv(tpool["sub0"][name][:, 1:], jpool["sub0"][name][:, 1:])
