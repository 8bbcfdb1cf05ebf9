"""Port of the transformer layers against the reference, in f32 on
identical numpy-made inputs: ``rms_norm``, ``rope``, ``_mask_bias``,
``blocked_attention`` and ``attention_block`` (no cache, dense cache,
paged pool with S == 1 and S > 1, the caches written in both).

Tolerance: f32 at atol 1e-5 (summation order), also where K/V pass
through a bf16 cache: both packages round the same f32 values to bf16,
and at these shapes no rounding lands on the other neighbour.
"""

from dataclasses import replace

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
from repro_torch.models import transformer as TT
from tests._torch_host import port_host_share  # noqa: F401 (autouse)


F32 = 1e-5


@pytest.fixture(autouse=True)
def _pinned_tilings(monkeypatch):
    # the reference's tuner would rank block sizes by a TPU roofline
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    # its paged decode on the CPU otherwise takes the gather path, which
    # rounds probabilities to bf16; the kernel (interpret mode) keeps f32
    # like the port's kernel and plain version
    monkeypatch.setenv("REPRO_PAGED_DECODE", "interpret")


def _close(t, j, atol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=0, atol=atol)


def _both(a, dtype=np.float32):
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def test_rms_norm():
    rng = np.random.default_rng(0)
    jx, tx = _both(rng.standard_normal((2, 5, 3, 32)) * 3)
    jw, tw = _both(rng.standard_normal(32) * 0.1)
    _close(TL.rms_norm(tx, tw), JL.rms_norm(jx, jw), F32)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope(per_row):
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.standard_normal((2, 7, 4, 32)))
    pos = (rng.integers(0, 3000, (2, 7)) if per_row
           else np.arange(100, 107)).astype(np.int32)
    jp, tp = _both(pos, np.int32)
    _close(TL.rope(tx, tp, 1e6), JL.rope(jx, jp, 1e6), F32)


@pytest.mark.parametrize("kind", ["causal", "chunked", "prefix", "full"])
def test_mask_bias(kind):
    # per-row positions with negative (left-pad) slots and per-row kv_len
    q = np.array([[-2, -1, 0, 1, 2], [0, 1, 2, 3, 4]], np.int32)
    k = np.arange(8, dtype=np.int32)[None] - np.array([[2], [0]], np.int32)
    kv_len = np.array([2, 6], np.int32)
    args = [_both(a, np.int32) for a in (q, k, kv_len)]
    t = TL._mask_bias(args[0][1], args[1][1], kind, 3, 2, args[2][1])
    j = JL._mask_bias(args[0][0], args[1][0], kind, 3, 2, args[2][0])
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    t = TL._mask_bias(torch.arange(5), torch.arange(8), kind, 3, 2, 4)
    j = JL._mask_bias(jnp.arange(5), jnp.arange(8), kind, 3, 2, 4)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("block_q", [None, 4])    # single block, scanned
@pytest.mark.parametrize("ragged", [False, True])
def test_blocked_attention(block_q, ragged):
    rng = np.random.default_rng(2)
    B, Sq, Sk, H, Hkv, Dh = 2, 12, 12, 8, 2, 32
    jq, tq = _both(rng.standard_normal((B, Sq, H, Dh)))
    jk, tk = _both(rng.standard_normal((B, Sk, Hkv, Dh)))
    jv, tv = _both(rng.standard_normal((B, Sk, Hkv, Dh)))
    if ragged:   # left-padded rows: per-row positions, negatives masked
        pad = np.array([[3], [0]], np.int32)
        qp = kp = np.arange(Sq, dtype=np.int32)[None] - pad
    else:
        qp = kp = np.arange(Sq, dtype=np.int32)
    (jqp, tqp), (jkp, tkp) = _both(qp, np.int32), _both(kp, np.int32)
    t = TL.blocked_attention(tq, tk, tv, q_positions=tqp, k_positions=tkp,
                             block_q=block_q)
    j = JL.blocked_attention(jq, jk, jv, q_positions=jqp, k_positions=jkp,
                             block_q=block_q)
    _close(t, j, F32)


@pytest.fixture(scope="module")
def attn():
    """Reduced qwen3-4b with GQA (4 query heads over 2 KV heads): layer 0's
    attention parameters, in f32, in both packages."""
    jcfg = replace(jax_config("qwen3-4b", reduced=True), n_kv_heads=2)
    tcfg = replace(get_config("qwen3-4b", reduced=True), n_kv_heads=2)
    tree = JT.init_params(jcfg, 0)
    # qk-norm weights are zero at init; make them matter
    rng = np.random.default_rng(9)
    for name in ("q_norm", "k_norm"):
        tree["blocks"]["sub0"]["attn"][name] = 0.1 * rng.standard_normal(
            tree["blocks"]["sub0"]["attn"][name].shape)
    jp = {k: jnp.asarray(np.asarray(v, np.float32)[0])
          for k, v in tree["blocks"]["sub0"]["attn"].items()}
    tp = params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
    return jcfg, tcfg, jp, tp.blocks[0].attn


def _jax_attention(x, p, cfg, **arrays):
    """The reference's attention_block under one jit (its eager op-by-op
    dispatch compiles every primitive separately)."""
    return jax.jit(lambda x, p, a: JL.attention_block(
        x, p, cfg, mask_kind="causal", **a))(x, p, arrays)


def _x(B, S, seed=4):
    return _both(np.random.default_rng(seed).standard_normal((B, S, 128)))


def test_attention_block_no_cache(attn):
    jcfg, tcfg, jp, tp = attn
    jx, tx = _x(2, 9)
    jpos, tpos = _both(np.arange(9), np.int32)
    t, _ = TL.attention_block(tx, tp, tcfg, positions=tpos, mask_kind="causal")
    j, _ = _jax_attention(jx, jp, jcfg, positions=jpos)
    _close(t, j, F32)


def test_attention_block_dense_cache(attn):
    """Left-padded prefill into a bf16 dense cache, then a per-row
    single-token decode write; outputs and caches agree."""
    jcfg, tcfg, jp, tp = attn
    B, S, L = 2, 6, 16
    pad = np.array([2, 0], np.int32)
    jpad, tpad = _both(pad, np.int32)
    pos = np.arange(S, dtype=np.int32)[None] - pad[:, None]
    jc = JT.init_cache(jcfg, B, L, stacked=False, zeros=jnp)["sub0"]
    tc = {k: v[0] for k, v in TT.init_cache(tcfg, B, L, device="cpu")["sub0"].items()}
    jx, tx = _x(B, S)
    t, tc = TL.attention_block(tx, tp, tcfg, positions=_both(pos, np.int32)[1],
                               mask_kind="causal", cache=tc, cache_len=0,
                               pos_offset=tpad)
    j, jc = _jax_attention(jx, jp, jcfg, positions=jnp.asarray(pos), cache=jc,
                           cache_len=jnp.int32(0), pos_offset=jpad)
    _close(t, j, F32)
    for name in ("k", "v"):
        _close(tc[name], jc[name], F32)

    # one decode step at per-row fill levels (no pos_offset: plain rows)
    cl = np.array([S, S + 3], np.int32)
    jcl, tcl = _both(cl, np.int32)
    jx, tx = _x(B, 1, seed=5)
    t, tc = TL.attention_block(tx, tp, tcfg, positions=tcl[:, None],
                               mask_kind="causal", cache=tc, cache_len=tcl)
    j, jc = _jax_attention(jx, jp, jcfg, positions=jcl[:, None], cache=jc,
                           cache_len=jcl)
    _close(t, j, F32)
    for name in ("k", "v"):
        _close(tc[name], jc[name], F32)


@pytest.mark.parametrize("S", [1, 5])
def test_attention_block_paged(attn, S):
    """Paged pool: S new tokens scatter at per-row offsets (incl. a block
    boundary) and attend — S == 1 through the paged decode path, S > 1
    over the gathered view; outputs and pools agree."""
    jcfg, tcfg, jp, tp = attn
    B, bs, n_blocks = 2, 8, 7
    rng = np.random.default_rng(6)
    pool = rng.standard_normal((n_blocks, bs, 2, 32))
    jk, tk = _both(jnp.asarray(pool, jnp.bfloat16), np.float32)
    jv, tv = _both(jnp.asarray(pool[::-1], jnp.bfloat16), np.float32)
    jcache = {"k_pool": jk.astype(jnp.bfloat16), "v_pool": jv.astype(jnp.bfloat16)}
    tcache = {"k_pool": tk.to(torch.bfloat16), "v_pool": tv.to(torch.bfloat16)}
    table = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    cl = np.array([5, bs], np.int32)           # row 1 writes at offset 0
    pos = cl[:, None] + np.arange(S, dtype=np.int32)
    jx, tx = _x(B, S)
    t, tcache = TL.attention_block(
        tx, tp, tcfg, positions=torch.from_numpy(pos), mask_kind="causal",
        cache=tcache, cache_len=torch.from_numpy(cl),
        block_table=torch.from_numpy(table))
    j, jcache = _jax_attention(
        jx, jp, jcfg, positions=jnp.asarray(pos), cache=jcache,
        cache_len=jnp.asarray(cl), block_table=jnp.asarray(table))
    _close(t, j, F32)
    for name in ("k_pool", "v_pool"):
        _close(tcache[name], jcache[name], F32)


def test_mlp_block(attn):
    rng = np.random.default_rng(8)
    w = {n: _both(rng.standard_normal(s) * 0.1) for n, s in
         (("gate", (128, 256)), ("up", (128, 256)), ("down", (256, 128)))}
    jx, tx = _x(2, 3)
    tp = TL.MLP(get_config("qwen3-4b", reduced=True), dtype=torch.float32,
                device="cpu")
    for n, (_, t) in w.items():
        getattr(tp, n).copy_(t)
    _close(TL.mlp_block(tx, tp), JL.mlp_block(jx, {n: j for n, (j, _) in w.items()}),
           F32)
