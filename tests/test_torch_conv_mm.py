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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: these CPU-sized cases gain
    little from more, and other test files run timed steps beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
