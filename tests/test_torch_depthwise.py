"""The port's depthwise convolution (``kernels.conv_mm.ops.depthwise_conv``)
on the CPU: in float64 its output and both gradients equal
``F.conv2d(groups=C)``'s on the same NCHW numbers, and
``depthwise_calls()`` counts one forward a depthwise layer of a step and
one backward a layer in training, none in a network without depthwise
layers."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.convert import cnn_params_from_numpy, tree_map
from repro_torch.core import profiler
from repro_torch.kernels.conv_mm.ops import depthwise_calls, depthwise_conv
from repro_torch.models import cnn
from tests._torch_host import port_host_share  # noqa: F401 (autouse)


def _counted(fn):
    """``fn()``'s result and the depthwise calls it made, each way."""
    before = depthwise_calls()
    out = fn()
    after = depthwise_calls()
    return out, {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv_equals_grouped_conv2d(stride, k):
    rng = np.random.default_rng(10 * stride + k)
    n, h, c, pad = 2, 9, 6, k // 2
    x = torch.tensor(rng.standard_normal((n, h, h, c)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((k, k, 1, c)), requires_grad=True)
    xr = x.detach().permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    wr = w.detach().permute(3, 2, 0, 1).contiguous().requires_grad_(True)

    def both():
        y = depthwise_conv(x, w, stride=stride, padding=pad)
        yr = F.conv2d(xr, wr, stride=stride, padding=pad, groups=c)
        gy = torch.tensor(rng.standard_normal(tuple(y.shape)))
        (y * gy).sum().backward()
        (yr * gy.permute(0, 3, 1, 2)).sum().backward()
        return y, yr

    (y, yr), calls = _counted(both)
    assert calls == {"forward": 1, "backward": 1}
    assert y.dtype == torch.float64 and y.shape == (n, (h + 2 * pad - k) // stride + 1,
                                                     (h + 2 * pad - k) // stride + 1, c)
    torch.testing.assert_close(y, yr.permute(0, 2, 3, 1), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(x.grad, xr.grad.permute(0, 2, 3, 1), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(w.grad, wr.grad.permute(2, 3, 1, 0), rtol=1e-12, atol=1e-12)


def _step(family, train):
    model = cnn.CNN_BUILDERS[family](width_mult=0.25, input_hw=32)
    params = cnn_params_from_numpy(model.init(0), device="cpu")
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((4, 32, 32, 3)).astype(np.float32))
    y = torch.tensor(rng.integers(0, model.num_classes, 4).astype(np.int32))
    if train:
        mom = tree_map(torch.zeros_like, params)
        step = profiler.make_train_step(model)
        return lambda: step(params, mom, x, y)
    infer = profiler.make_infer_fn(model)
    return lambda: infer(params, x)


@pytest.mark.parametrize("family, train, expected", [
    ("mobilenetv2", True, {"forward": 17, "backward": 17}),
    ("mobilenetv2", False, {"forward": 17, "backward": 0}),
    ("resnet50", True, {"forward": 0, "backward": 0}),
])
def test_depthwise_calls_in_a_step(family, train, expected):
    assert _counted(_step(family, train))[1] == expected
