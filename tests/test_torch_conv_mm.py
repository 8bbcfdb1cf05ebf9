"""Port of the MM convolution against the reference: the port's
``ops.conv_mm`` on CPU tensors (its plain version, ``ref.conv_ref``)
against the Pallas ``conv_mm_kernel`` run in interpret mode and the XLA
``conv_ref``, on identical numpy-made inputs; its gradients against
``jax.grad`` of the XLA convolution.

Tolerances are the reference kernel tests' (``tests/test_kernels.py``):
f32 rtol/atol 2e-4 (sums taken in another order), bf16 rtol/atol 3e-2
(both sides sum in f32 and round once to bf16, which may land on either
neighbour).  Gradients are f32 at rtol/atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_mm import tiling as jax_tiling
from repro.kernels.conv_mm.kernel import conv_mm_kernel
from repro.kernels.conv_mm.ref import conv_im2col_ref as jax_im2col
from repro.kernels.conv_mm.ref import conv_ref as jax_conv
from repro_torch.kernels.conv_mm import conv_im2col_ref, conv_mm, conv_ref
from repro_torch.kernels.conv_mm import tiling
from tests._torch_host import port_host_share  # noqa: F401 (autouse)


TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

CONV_SHAPES = [
    # (N, H, W, C, KH, O, stride, padding), as tests/test_kernels.py
    (2, 8, 8, 8, 3, 16, 1, 1),
    (1, 16, 16, 4, 3, 8, 2, 1),
    (2, 8, 8, 16, 1, 32, 1, 0),     # 1x1 conv
    (1, 9, 9, 8, 5, 8, 2, 2),       # 5x5 stride 2
    (2, 8, 8, 3, 3, 8, 1, 0),       # valid padding
]


def _case(spec, dtype, seed=2):
    """x and w drawn with numpy as the reference test draws them, rounded
    once to ``dtype`` by JAX; torch gets the same values."""
    N, H, W, C, K, O, _, _ = spec
    rng = np.random.default_rng(seed)
    jx = jnp.asarray(rng.standard_normal((N, H, W, C)), JAX_DT[dtype])
    jw = jnp.asarray(rng.standard_normal((K, K, C, O)), JAX_DT[dtype]) * 0.2
    tx, tw = (torch.from_numpy(np.array(a, np.float32)).to(TORCH_DT[dtype])
              for a in (jx, jw))
    return jx, jw, tx, tw


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", CONV_SHAPES)
def test_conv_mm_cpu_matches_pallas_and_xla(spec, dtype):
    *_, s, p = spec
    jx, jw, tx, tw = _case(spec, dtype)
    got = conv_mm(tx, tw, stride=s, padding=p)
    assert got.dtype == TORCH_DT[dtype]
    pallas = conv_mm_kernel(jx, jw, stride=s, padding=p, block_o=spec[5],
                            interpret=True)
    for want in (pallas, jax_conv(jx, jw, stride=s, padding=p)):
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **TOL[dtype])


@pytest.mark.parametrize("spec", CONV_SHAPES)
def test_conv_im2col_ref_matches_reference(spec):
    *_, s, p = spec
    jx, jw, tx, tw = _case(spec, "float32", seed=3)
    got = conv_im2col_ref(tx, tw, stride=s, padding=p)
    np.testing.assert_allclose(_np(got), np.asarray(jax_im2col(jx, jw, stride=s,
                                                               padding=p)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(got), _np(conv_ref(tx, tw, stride=s, padding=p)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("spec", CONV_SHAPES)
def test_conv_mm_grads_match_jax(spec):
    """dx and dw of sum(conv(x, w) * g) against ``jax.grad`` of the XLA
    convolution."""
    *_, s, p = spec
    jx, jw, tx, tw = _case(spec, "float32", seed=4)
    g = np.random.default_rng(5).standard_normal(
        jax_conv(jx, jw, stride=s, padding=p).shape).astype(np.float32)

    def loss(x, w):
        return jnp.sum(jax_conv(x, w, stride=s, padding=p) * g)

    jdx, jdw = jax.grad(loss, argnums=(0, 1))(jx, jw)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    (conv_mm(tx, tw, stride=s, padding=p) * torch.from_numpy(g)).sum().backward()
    assert tx.grad.shape == tx.shape and tw.grad.shape == tw.shape
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jdx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tw.grad), np.asarray(jdw), rtol=1e-4, atol=1e-4)


def test_conv_mm_on_meta_keeps_shape_and_counts_flops():
    """The profiler counts flops on the meta device: the plain version
    runs there (no kernel), and forward + both grads count 3× the
    convolution's 2·M·K·O."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.empty(2, 9, 9, 8, device="meta", requires_grad=True)
    w = torch.empty(5, 5, 8, 6, device="meta", requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        y = conv_mm(x, w, stride=2, padding=2)
        y.sum().backward()
    assert y.shape == (2, 5, 5, 6) and y.device.type == "meta"
    assert counter.get_total_flops() == 3 * 2 * (2 * 5 * 5) * (5 * 5 * 8) * 6


@pytest.mark.parametrize("spec", CONV_SHAPES + [(1, 8, 8, 4, 3, 96, 1, 1),
                                                (1, 8, 8, 4, 3, 300, 1, 1)])
def test_tiling_matches_reference(spec):
    N, H, W, C, K, O, s, p = spec
    x_shape, w_shape = (N, H, W, C), (K, K, C, O)
    mine = tiling.shape_key(x_shape, w_shape, stride=s, padding=p,
                            dtype=torch.float32)
    ref = jax_tiling.shape_key(x_shape, w_shape, stride=s, padding=p,
                               dtype=np.dtype("float32"))
    assert mine == ref
    assert tiling.default(mine) == jax_tiling.default(ref)
    assert tiling.candidates(mine) == jax_tiling.candidates(ref)


@pytest.mark.parametrize("M,O,tile", [
    (128 * 32 * 32, 64, (64, 64)),      # bs 128, 32x32, O 64: the stem
    (128 * 4 * 4, 512, (64, 64)),       # bs 128, the 4x4 stage: 64 tiles of 128
    (128 * 4 * 4, 2048, (128, 128)),    # 256 tiles of 128 x 128
    (128 * 8 * 8, 256, (128, 128)),     # bs 128, the 8x8 stage: 128 tiles
    (2 * 32 * 32, 64, (64, 64)),        # bs 2
    (132 * 128, 128, (128, 128)),       # exactly one 128 x 128 tile per SM
    (133 * 64, 128, (128, 128)),        # 266 tiles of 64 x 64: a second wave
    (132 * 64, 128, (64, 64)),          # 264: one wave of two an SM
    (131 * 128, 65, (128, 128)),        # O 65 takes the 128-wide tile
    (8 * 32 * 32, 128, (64, 64)),       # the bench shape in f32: 64 tiles of 128
    (3 * 7 * 5, 70, (64, 64)),          # chip_smoke's O 70 edge case
    (1, 1, (64, 64)),
])
def test_conv_tile_rule(M, O, tile):
    """The f32 (3xTF32 ``wgmma``) kernel's tile, one warpgroup per 64
    pixels: 128 x 128 where O > 64 and the 64 x 64 grid has more than two
    blocks for each of the 132 SMs, else 64 x 64; ``tile_for`` picks it for
    f32."""
    assert tiling.NUM_SMS == 132
    assert tiling.conv_tile(M, O) == tile
    assert tiling.tile_for(M, O, torch.float32) == tiling.tile_for(M, O, "float32") == tile


# the bf16 (wgmma) kernel's tile, BM pixels (one warpgroup per 64) by BN
# channels: the kernel bench's GEMM, M 8192 x O 128, must give the 132 SMs at
# least 128 blocks (64 of 128 x 128 would leave half of them idle)
BF16_TILES = [
    (8 * 32 * 32, 128, (64, 128)),      # the kernel bench's shape: 128 blocks
    (128 * 32 * 32, 64, (128, 64)),     # bs 128, the 32x32 stage at O 64
    (128 * 32 * 32, 256, (128, 128)),
    (128 * 4 * 4, 2048, (128, 128)),    # 256 tiles of 128 x 128
    (128 * 4 * 4, 512, (64, 128)),      # 64 tiles of 128 would leave SMs idle
    (2 * 32 * 32, 64, (64, 64)),        # bs 2
    (3 * 7 * 5, 70, (64, 128)),         # chip_smoke's O 70 edge case
    (1, 1, (64, 64)),
]


@pytest.mark.parametrize("M,O,tile", BF16_TILES)
def test_conv_tile_bf16_rule(M, O, tile):
    """``conv_tile_bf16``, and ``tile_for`` picking it for bf16 only."""
    assert tiling.conv_tile_bf16(M, O) == tile
    assert tiling.tile_for(M, O, "bfloat16") == tiling.tile_for(M, O, torch.bfloat16) == tile
    assert tiling.tile_for(M, O, torch.float32) == tiling.conv_tile(M, O)


def test_conv_tile_bf16_fills_the_card_at_the_bench_shape():
    M, O = 8 * 32 * 32, 128
    bm, bn = tiling.conv_tile_bf16(M, O)
    assert -(-M // bm) * -(-O // bn) >= 128


@pytest.mark.parametrize("O", [1, 3, 8, 13, 64, 65, 70, 128, 256, 512, 2048])
def test_every_bf16_tile_fits_a_block_s_shared_memory(O):
    """Every tile the bf16 rule gives is one the kernel instantiates and
    fits the 232,448 bytes of shared memory a Hopper block may take."""
    for M in (1, 64, 105, 2048, 8192, 16384, 16896, 131072, 2**24):
        bm, bn = tiling.conv_tile_bf16(M, O)
        assert bm in (64, 128) and bn in (64, 128)
        assert tiling.smem_bytes(bm, bn, "bfloat16") <= 232448


@pytest.mark.parametrize("O", [1, 3, 8, 13, 64, 65, 70, 128, 256, 512, 2048])
def test_every_f32_tile_fits_a_block_s_shared_memory(O):
    """Every tile the f32 rule gives is one the 3xTF32 kernel instantiates
    and fits the 232,448 bytes of shared memory a Hopper block may take,
    the largest (128 x 128, 197,632 bytes) included."""
    for M in (1, 64, 105, 2048, 8192, 16384, 16896, 131072, 2**24):
        bm, bn = tiling.conv_tile(M, O)
        assert (bm, bn) in ((64, 64), (128, 128))
        assert tiling.smem_bytes(bm, bn, "float32") <= 232448
    assert tiling.smem_bytes(128, 128, "float32") == 197632


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile", [(64, 64), (64, 128), (128, 64), (128, 128)])
def test_smem_bytes_formula(tile, dtype):
    """Shared memory of one block of the CUDA kernel (``conv_mm_smem_bytes``
    in the source): 1024 bytes of alignment slack and a ring of 4 stages;
    f32, each stage a bm x 32 A tile and a 32 x bn w tile, f32, and two
    K-major [hi | lo] pairs of bn x 32 f32; bf16, each stage a bm x 64 A
    tile and a 64 x bn B tile, bf16.  ``cost`` reports the tile the dtype's
    rule gives."""
    bm, bn = tile
    want = (1024 + 4 * 4 * 32 * (bm + bn) + 2 * 2 * 4 * 32 * bn if dtype == "float32"
            else 1024 + 2 * 4 * 64 * (bm + bn))
    assert tiling.smem_bytes(bm, bn, dtype) == want
    assert tiling.smem_bytes(bm, bn, TORCH_DT[dtype]) == want
    # a shape the rule gives this tile: N x 32 x 32 pixels, O channels; the
    # f32 rule gives 64 x 64 and 128 x 128 only, the f32 kernel's only tiles
    N = 128 if bm == 128 else 2
    O = 64 if bn == 64 else 256
    if dtype == "float32" and bm != bn:
        assert all(tiling.tile_for(n * 32 * 32, o, dtype) != tile
                   for n in (1, 2, 8, 32, 128, 256) for o in (8, 64, 65, 256, 2048))
        return
    shape = tiling.shape_key((N, 32, 32, 64), (3, 3, 64, O), stride=1, padding=1,
                             dtype=TORCH_DT[dtype])
    assert tiling.tile_for(N * 32 * 32, O, dtype) == tile
    assert tiling.cost(shape, tiling.default(shape)).smem_bytes == want
