"""BatchNorm with batch statistics and its activation
(``repro_torch.kernels.batchnorm``).

On the CPU: the closed-form backward of ``ref.py`` (the plain version of
what the CUDA kernels compute) against autograd of the CNN's formula in
float64, the kernel-or-plain choice by device and its count,
``chip_smoke.bn_count`` against the BatchNorms a pruned network calls, and
the kernel wrapper's refusals.  On the card (marker ``card``; they skip
without one): the kernels against the plain version in float64 at every
BatchNorm shape of ResNet-50 and ResNet-18 at batch 2, at odd pruned widths
and through autograd.  Run them on a machine with the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_batchnorm.py``.
This file imports no JAX, so it runs where the port runs.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.convert import cnn_params_from_numpy
from repro_torch.core.dataset import GridSpec, _build_pruned
from repro_torch.kernels.batchnorm import ops
from repro_torch.kernels.batchnorm.kernel import BatchNormKernel, batchnorm_cuda
from repro_torch.kernels.batchnorm.ref import (ACTS, activation, batchnorm_act_backward_ref,
                                               batchnorm_act_forward_ref, batchnorm_act_ref)
from repro_torch.models import cnn


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def bn_shapes(model, batch: int) -> list[tuple[tuple[int, int, int, int], str]]:
    """((N, OH, OW, C), act) of every BatchNorm of the model's graph, in the
    order ``apply`` runs them."""
    found = []

    def walk(node, s):
        if isinstance(node, cnn.Seq):
            for n in node.nodes:
                s = walk(n, s)
            return s
        if isinstance(node, cnn.Residual):
            out = walk(node.body, s)
            if node.shortcut is not None:
                walk(node.shortcut, s)
            return out
        if isinstance(node, cnn.Concat):
            for b in node.branches:
                walk(b, s)
        out = node.out_shape(s)
        if isinstance(node, cnn.C) and node.bn:
            found.append(((batch, *out), node.act))
        return out

    walk(model.graph, (model.input_hw, model.input_hw, 3))
    return found


def _inputs(shape, dtype, device, seed: int = 0):
    """y, scale, shift, dz: y off-centre, scale and shift wide enough that
    p = x·scale + shift crosses both 0 and 6."""
    gen = torch.Generator().manual_seed(seed)
    C = shape[-1]
    y = torch.randn(shape, generator=gen, dtype=torch.float64) * 2.0 + 0.5
    scale = torch.rand(C, generator=gen, dtype=torch.float64) * 3.5 + 0.5
    shift = torch.randn(C, generator=gen, dtype=torch.float64) * 2.0
    dz = torch.randn(shape, generator=gen, dtype=torch.float64)
    return [t.to(dtype=dtype, device=device) for t in (y, scale, shift, dz)]


def _autograd(y, scale, shift, dz, act):
    y, scale, shift = (t.detach().requires_grad_(True) for t in (y, scale, shift))
    z = batchnorm_act_ref(y, scale, shift, act)
    return (z.detach(), *torch.autograd.grad(z, (y, scale, shift), dz))


# -- CPU ----------------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 7, 512])
@pytest.mark.parametrize("C", [1, 3, 37, 64])
@pytest.mark.parametrize("act", ACTS)
def test_closed_form_backward_matches_autograd(act, C, M):
    shape = {1: (1, 1, 1, C), 7: (7, 1, 1, C), 512: (2, 16, 16, C)}[M]
    y, scale, shift, dz = _inputs(shape, torch.float64, "cpu", seed=C * 1000 + M)
    z_auto, dy_auto, dscale_auto, dshift_auto = _autograd(y, scale, shift, dz, act)

    z, mean, rstd = batchnorm_act_forward_ref(y, scale, shift, act)
    dy, dscale, dshift = batchnorm_act_backward_ref(dz, y, scale, shift, mean, rstd, act)
    torch.testing.assert_close(z, z_auto, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dshift, dshift_auto, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(dscale, dscale_auto, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(dy, dy_auto, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_plain_formula_off_the_card(device):
    y, scale, shift, dz = _inputs((2, 4, 4, 8), torch.float32, device)
    before = ops.batchnorm_calls()
    y.requires_grad_(True)
    z = ops.batchnorm_act(y, scale, shift, "relu")
    after = ops.batchnorm_calls()
    assert after == {**before, "plain": before["plain"] + 1}
    assert z.shape == y.shape and z.device.type == device and z.requires_grad
    if device == "cpu":   # the eager formula, op for op
        want = torch.relu((y - y.mean((0, 1, 2), keepdim=True))
                          * torch.rsqrt(y.var((0, 1, 2), unbiased=False, keepdim=True) + 1e-5)
                          * scale + shift)
        assert torch.equal(z, want)


@pytest.mark.parametrize("builder, n_bn", [("build_resnet18", 20), ("build_resnet50", 53),
                                           ("build_mobilenetv2", 52)])
def test_cnn_batchnorms_count_on_the_cpu(builder, n_bn):
    model = getattr(cnn, builder)(width_mult=0.25, input_hw=8)
    assert len(bn_shapes(model, 2)) == n_bn
    params = cnn_params_from_numpy(model.init(0), device="cpu")
    x = torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    before = ops.batchnorm_calls()
    with torch.no_grad():
        model.apply(params, x)
    after = ops.batchnorm_calls()
    assert after["plain"] - before["plain"] == n_bn
    assert after["kernel"] == before["kernel"]
    assert after["kernel_backward"] == before["kernel_backward"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("family", sorted(cnn.CNN_BUILDERS))
def test_chip_smoke_counts_every_batchnorm(family):
    """``chip_smoke.bn_count``, which sets the launch counts the card run
    gates on, equals the BatchNorms a pruned network's forward calls."""
    level = 0.55
    model = _build_pruned(GridSpec(family, (level,), "random", (2,), 0.25, 16), level)
    params = cnn_params_from_numpy(model.init(0), device="cpu")
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    before = ops.batchnorm_calls()
    with torch.no_grad():
        model.apply(params, x)
    calls = ops.batchnorm_calls()["plain"] - before["plain"]
    assert _chip_smoke().bn_count(model) == calls == len(bn_shapes(model, 2))


@pytest.mark.parametrize("case", ["cpu", "act", "dtype", "shape"])
def test_kernel_wrapper_refuses(case):
    y, scale, shift, _ = _inputs((2, 2, 2, 4), torch.float32, "cpu")
    kernel = BatchNormKernel()
    with pytest.raises((ValueError, TypeError)):
        if case == "cpu":
            kernel.forward(y, scale, shift, "relu")
        elif case == "act":
            kernel.forward(y, scale, shift, "gelu")
        elif case == "dtype":
            kernel.forward(y.double(), scale, shift, "relu")
        else:
            kernel.forward(y, scale[:3], shift, "relu")
    assert kernel._lib is None     # refused before any build
    assert kernel.forward_launches == kernel.backward_launches == 0


# -- the card -----------------------------------------------------------------


def _check_kernel(shape, act, card, seed=0, offset=0):
    """The kernels' forward and backward against the plain version on the
    card; ``offset`` floats shift y off 16-byte alignment.  z is the plain
    formula of the kernels' own mean and rstd, to the bit (its p rounded as
    eager f32 ops round it); mean, rstd, the sums and dy are held against
    float64, dy with dz masked where the kernels' p says (an element whose
    p lies within rounding of 0 or 6 may take either side)."""
    y64, scale64, shift64, dz64 = _inputs(shape, torch.float64, card, seed)
    y = torch.empty(y64.numel() + offset, dtype=torch.float32, device=card)[offset:]
    y = y.view(shape).copy_(y64)
    scale, shift, dz = (t.float() for t in (scale64, shift64, dz64))
    z, mean, rstd = batchnorm_cuda.forward(y, scale, shift, act)
    dy, dscale, dshift = batchnorm_cuda.backward(dz, y, scale, shift, mean, rstd, act)
    torch.cuda.synchronize()
    p = ((y - mean) * rstd) * scale + shift
    assert torch.equal(z, activation(p, act)), (shape, act)
    keep = {"relu": p > 0, "relu6": (p > 0) & (p < 6), "none": torch.ones_like(p, dtype=bool)}
    y64 = y.double()
    _, mean_ref, rstd_ref = batchnorm_act_forward_ref(y64, scale64, shift64, act)
    dy_ref, dscale_ref, dshift_ref = batchnorm_act_backward_ref(
        torch.where(keep[act], dz64, 0.0), y64, scale64, shift64, mean_ref, rstd_ref, "none")

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max().clamp_min(1e-30))

    errs = {"mean": float((mean.double() - mean_ref).abs().max() * rstd_ref.max()),
            "rstd": rel(rstd, rstd_ref), "dshift": rel(dshift, dshift_ref),
            "dscale": rel(dscale, dscale_ref), "dy": rel(dy, dy_ref)}
    # f32 rounding of sums over M rows
    assert max(errs.values()) < 1e-4, (shape, act, errs)


@pytest.mark.card
@pytest.mark.parametrize("builder", ["build_resnet50", "build_resnet18"])
def test_kernel_at_every_resnet_shape(builder, card):
    shapes = sorted(set(bn_shapes(getattr(cnn, builder)(), 2)))
    for i, (shape, act) in enumerate(shapes):
        _check_kernel(shape, act, card, seed=i)


@pytest.mark.card
@pytest.mark.parametrize("act", ACTS)
def test_kernel_at_odd_widths(act, card):
    for i, shape in enumerate([(1, 1, 1, 1), (3, 5, 7, 3), (2, 3, 3, 37), (5, 7, 1, 61),
                               (2, 8, 8, 130), (1, 1, 3, 2047), (7, 9, 11, 12)]):
        _check_kernel(shape, act, card, seed=i)
    _check_kernel((2, 8, 8, 64), act, card, seed=99, offset=1)   # C % 4 == 0, unaligned


@pytest.mark.card
def test_autograd_through_the_kernel(card):
    y, scale, shift, dz = _inputs((4, 8, 8, 32), torch.float32, card)
    before = ops.batchnorm_calls()
    leaves = [t.clone().requires_grad_(True) for t in (y, scale, shift)]
    z = ops.batchnorm_act(*leaves, "none")
    assert ops.batchnorm_calls() == {**before, "kernel": before["kernel"] + 1}
    grads = torch.autograd.grad(z, leaves, dz)
    assert ops.batchnorm_calls() == {**before, "kernel": before["kernel"] + 1,
                                     "kernel_backward": before["kernel_backward"] + 1}
    want = _autograd(*(t.double() for t in (y, scale, shift, dz)), "none")
    for got, ref in zip((z, *grads), want):
        assert float((got.double() - ref).abs().max() / ref.abs().max()) < 1e-4
    with torch.no_grad():
        assert torch.equal(ops.batchnorm_act(y, scale, shift, "none"), z.detach())
