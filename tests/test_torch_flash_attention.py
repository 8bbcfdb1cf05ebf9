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
    (128, 512, "float32", True), (128, 640, "float32", True),
    (128, 1024, "float32", False), (64, 1024, "float32", False),
    (64, 640, "float32", True), (32, 64, "float32", True),
    (128, 512, "bfloat16", True), (128, 2048, "bfloat16", True),
    (128, 64, "bfloat16", True), (128, 65, "bfloat16", True),
    (64, 1024, "bfloat16", True), (32, 1, "bfloat16", True)])
def test_smem_formula_and_budget(Dh, block_k, dtype, fits):
    """The shared-memory number the tiling reports (and the CUDA source
    computes) against Hopper's per-block budget.  f32 (CUDA cores): a
    64 × block_k f32 score strip, so a wide step does not fit.  bf16
    (tensor cores): the Q pass and two stages of a K and a V tile of
    ``kv_tile(block_k)`` keys, bf16, behind 1024 B of alignment slack and
    beside 128 B of barriers; the tile is capped at 128 keys, so every
    block_k fits."""
    from repro_torch.kernels.autotune import SMEM_BYTES_PER_BLOCK

    if dtype == "float32":
        want = 4 * (64 * (Dh + 1) * 2 + 64 * (block_k + 1) + 3 * 64)
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
