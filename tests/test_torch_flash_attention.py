"""Port of flash attention against the reference: the port's plain
``attention_ref`` and its ``ops.flash_attention`` (CPU tensors) against the
JAX ``attention_ref`` and the Pallas ``flash_attention_kernel`` run in
interpret mode, on identical numpy-made inputs; plus the shape rules the
CUDA wrapper shares with the reference.

Tolerances: f32 at atol 2e-5 (summation order differs between the
frameworks and between a full and an online softmax); bf16 outputs at
atol 1e-2, about one bf16 ulp at |x| ≤ 2, since both sides compute in f32
and round once to bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.autotune import (KernelTuner, largest_dividing_block,
                                          set_tuner)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import tiling
from tests._torch_host import port_host_share  # noqa: F401 (autouse)


TOL = {"float32": 2e-5, "bfloat16": 1e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (B, H, Hkv, Sq, Sk, Dh, causal, block_q, block_k, q_offset)
CASES = [
    (1, 2, 2, 128, 128, 32, True, 64, 64, 0),
    (2, 4, 2, 128, 128, 64, True, 64, 64, 0),      # GQA 2:1
    (2, 8, 1, 64, 64, 32, True, 32, 32, 0),        # MQA
    (1, 2, 2, 128, 128, 32, False, 64, 64, 0),     # bidirectional
    (1, 2, 1, 64, 256, 32, True, 64, 64, 192),     # Sk > Sq, last q on last k
    (1, 4, 2, 32, 128, 64, True, 32, 64, 64),      # chunked-prefill chunk
    (2, 4, 2, 1, 128, 64, True, 512, 512, 127),    # decode: Sq = 1
    (1, 2, 2, 96, 96, 32, True, 64, 64, 0),        # non-dividing: blocks snap to 48
    (1, 2, 2, 16, 48, 32, True, 8, 16, -4),        # rows 0-3 fully masked
    (1, 2, 2, 64, 200, 32, True, 64, 64, -4),      # the same, Sk no multiple of 64
]


@pytest.fixture(autouse=True)
def _isolated_default_tuner(tmp_path):
    set_tuner(KernelTuner(device="tpu_v5e", cache=str(tmp_path / "tune.json"),
                          measure=False))
    yield
    set_tuner(None)


def _inputs(B, H, Hkv, Sq, Sk, Dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s) for s in
              ((B, H, Sq, Dh), (B, Hkv, Sk, Dh), (B, Hkv, Sk, Dh))]
    j = [jnp.asarray(a, dtype) for a in arrays]
    t = [torch.from_numpy(np.array(a, np.float32)).to(TORCH_DT[dtype]) for a in j]
    return j, t


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_version_matches_pallas_kernel_and_ref(case, dtype):
    B, H, Hkv, Sq, Sk, Dh, causal, bq, bk, off = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, H, Hkv, Sq, Sk, Dh, dtype)
    want_kernel = flash_attention_kernel(jq, jk, jv, causal=causal, block_q=bq,
                                         block_k=bk, q_offset=off, interpret=True)
    want_ref = jax_ref(jq, jk, jv, causal=causal, q_offset=off)
    got = attention_ref(tq, tk, tv, causal=causal, q_offset=off)
    got_ops = flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                              block_k=bk, q_offset=off)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, H, Sq, Dh)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])
    assert torch.equal(got_ops, got)


@pytest.mark.parametrize("Sk,block_k", [(16, 16), (200, 64)])
def test_fully_masked_row_is_mean_of_v(Sk, block_k):
    """NEG_INF = -1e30 is finite: a row that sees no key (q_offset + i < 0)
    weighs every key by exp(0) = 1 and returns mean(V), in the Pallas
    kernel, the reference's oracle and the port alike; Sk = 200 is no
    multiple of the CUDA kernel's 64- and 128-key tiles, whose missing
    keys must add nothing to the mean."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 2, 2, 8, Sk, 32, "float32", seed=3)
    got = attention_ref(tq, tk, tv, causal=True, q_offset=-4)
    mean_v = tv.mean(dim=2)                                  # (B, H, Dh)
    for r in range(4):
        np.testing.assert_allclose(got[:, :, r].numpy(), mean_v.numpy(),
                                   rtol=0, atol=1e-6)
    want = flash_attention_kernel(jq, jk, jv, causal=True, q_offset=-4,
                                  block_q=8, block_k=block_k, interpret=True)
    np.testing.assert_allclose(np.asarray(want)[:, :, 0], mean_v.numpy(),
                               rtol=0, atol=1e-6)
    # row 4 (position 0) sees key 0 only
    np.testing.assert_allclose(got[:, :, 4].numpy(), tv[:, :, 0].numpy(),
                               rtol=0, atol=1e-6)


def test_ops_consults_the_tuner_for_missing_blocks():
    """block_q/block_k = None resolve through the process tuner for this
    launch shape (one miss, then hits), as the reference's ops do."""
    tuner = KernelTuner(device="tpu_v5e", cache=None, measure=False)
    set_tuner(tuner)
    (_, (tq, tk, tv)) = _inputs(1, 4, 2, 64, 64, 32, "float32")
    a = flash_attention(tq, tk, tv)
    b = flash_attention(tq, tk, tv, block_q=16)
    assert (tuner.misses, tuner.hits) == (1, 1)
    assert torch.equal(a, b)
    shape = tiling.shape_key(tq.shape, tk.shape, causal=True, dtype=tq.dtype)
    assert shape["dtype"] == "float32"
    assert tuner.explain("flash_attention", shape)["source"] == "model"


@pytest.mark.parametrize("Dh,block_k,dtype,fits", [
    (128, 512, "float32", True), (128, 32, "float32", True),
    (128, 1024, "float32", True), (64, 1024, "float32", True),
    (64, 33, "float32", True), (32, 1, "float32", True),
    (128, 512, "bfloat16", True), (128, 2048, "bfloat16", True),
    (128, 64, "bfloat16", True), (128, 65, "bfloat16", True),
    (64, 1024, "bfloat16", True), (32, 1, "bfloat16", True)])
def test_smem_formula_and_budget(Dh, block_k, dtype, fits):
    """The shared-memory number the tiling reports (and the CUDA source
    computes) against Hopper's per-block budget.  f32 (3xTF32 on the
    tensor cores): 1024 B of alignment slack, the 128-row Q pass, two
    stages of a K tile and K's lo part, and two stages of a V tile (rows
    padded to Dh + 4), of ``f32_kv_tile(Dh, block_k)`` keys (32 for
    block_k ≤ 32, else 64), all f32.  bf16 (``wgmma``): the Q pass and
    two stages of a K and a V tile of ``kv_tile(block_k)`` keys, bf16,
    behind 1024 B of alignment slack and beside 128 B of barriers; the
    tile is capped at 128 keys.  Both tiles are capped, so every block_k
    fits."""
    from repro_torch.kernels.autotune import SMEM_BYTES_PER_BLOCK

    if dtype == "float32":
        tile = 32 if block_k <= 32 else 64
        assert tiling.f32_kv_tile(Dh, block_k) == tile
        want = 1024 + 4 * (128 * Dh + 3 * tile * Dh + 2 * tile * (Dh + 4))
    else:
        tile = 64 if block_k <= 64 else 128
        assert tiling.kv_tile(block_k) == tile
        want = 1024 + 2 * (128 * Dh + 2 * 2 * tile * Dh) + 128
    assert tiling.smem_bytes(Dh, block_k, dtype) == want
    assert tiling.smem_bytes(Dh, block_k, TORCH_DT[dtype]) == want
    assert (want <= SMEM_BYTES_PER_BLOCK) == fits
    shape = tiling.shape_key((1, 4, 2048, Dh), (1, 2, 2048, Dh), causal=True,
                             dtype=TORCH_DT[dtype])
    assert tiling.cost(shape, {"block_q": 512, "block_k": block_k}).smem_bytes == (
        tiling.smem_bytes(Dh, largest_dividing_block(2048, block_k), dtype))


_TF32_MASK = -8192                      # 0xffffe000 as an int32


def _tf32(x, rounding):
    """x's TF32 part: the low 13 mantissa bits cleared, after adding half an
    ulp when rounding to nearest (``ssd_chunk.cu``'s ``split_tf32``); the
    tensor cores themselves clear them (round toward zero)."""
    bits = x.contiguous().view(torch.int32)
    if rounding:
        bits = bits + 0x1000
    return (bits & _TF32_MASK).view(torch.float32)


def _tf32_product(a, b, terms, rounding):
    """a @ b as the kernel forms it: three TF32 products (x = hi + lo, the
    small terms first, each product exact and summed in f32) or one
    (both operands rounded to nearest TF32)."""
    if terms == 1:
        return _tf32(a, True) @ _tf32(b, True)
    ah, bh = _tf32(a, rounding), _tf32(b, rounding)
    al, bl = _tf32(a - ah, rounding), _tf32(b - bh, rounding)
    return al @ bh + ah @ bl + ah @ bh


def _emulated_f32_kernel(q, k, v, *, q_offset, terms, rounding, tile=64):
    """The f32 CUDA kernel's arithmetic on the CPU: q pre-scaled, S = Q Kᵀ
    and O += P V in TF32 products, an online softmax in the log2 domain
    over ``tile``-key tiles (a masked score is -1e30, as in the
    reference), O divided by the row sum at the end."""
    H, Sq, Dh = q.shape[1], q.shape[2], q.shape[3]
    Sk = k.shape[2]
    rep = H // k.shape[1]
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    qs = q * np.float32(1 / np.sqrt(Dh))
    m = torch.full(q.shape[:3] + (1,), -1e30)
    l, o = torch.zeros(q.shape[:3] + (1,)), torch.zeros(q.shape)
    pos = q_offset + torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, tile):
        kt, vt = k[:, :, k0:k0 + tile], v[:, :, k0:k0 + tile]
        s = _tf32_product(qs, kt.transpose(-1, -2), terms, rounding) * 1.4426950408889634
        s = torch.where(pos >= k0 + torch.arange(kt.shape[2])[None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _tf32_product(p, vt, terms, rounding)
        m = m_new
    return o / l


@pytest.mark.parametrize("rounding", [False, True], ids=["truncating", "rounding"])
def test_three_tf32_terms_hold_f32_attention(rounding):
    """The f32 kernel keeps f32 accuracy on the tensor cores because each
    f32 product is three TF32 products: its arithmetic, emulated here with
    the kernel's split (truncating: hi = x with the low 13 mantissa bits
    cleared, lo = x - hi as the tensor cores read it) and with
    ``ssd_chunk``'s rounding split, holds the JAX reference at the f32
    gate of 1e-4 (``chip_smoke.FLASH_TOL``), at Dh 128 over 45 to 300 keys
    with GQA and a ragged last tile (about 1e-6), while one TF32 product
    (each operand rounded to nearest) misses it on the same inputs (about
    6e-4)."""
    B, H, Hkv, Sq, Sk, Dh, q_offset = 1, 4, 2, 256, 300, 128, 44
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, H, Hkv, Sq, Sk, Dh, "float32", seed=5)
    want = np.asarray(jax_ref(jq, jk, jv, causal=True, q_offset=q_offset))
    three = _emulated_f32_kernel(tq, tk, tv, q_offset=q_offset, terms=3, rounding=rounding)
    one = _emulated_f32_kernel(tq, tk, tv, q_offset=q_offset, terms=1, rounding=rounding)
    err3 = float(np.abs(three.numpy() - want).max())
    err1 = float(np.abs(one.numpy() - want).max())
    assert err3 <= 1e-4, err3
    assert err1 > 1e-4, err1
