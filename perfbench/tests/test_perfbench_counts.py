"""The benchmark's flop and byte arithmetic against hand counts and
against PyTorch's ``FlopCounterMode`` on the meta device."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts
from perfbench.reference import cnn as ref
from perfbench.spec import HERE


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("n,h,cin,cout,k,stride", [
    (2, 32, 64, 64, 3, 1),      # a ResNet 3x3
    (4, 16, 256, 64, 1, 1),     # a bottleneck's 1x1 reduction
    (3, 32, 256, 512, 1, 2),    # a strided projection shortcut
    (1, 32, 3, 64, 3, 1),       # the CIFAR stem
])
def test_conv_counts_by_hand(n, h, cin, cout, k, stride):
    c = ref.Conv("c", cin, cout, k, stride, True, h, h)
    oh = (h + 2 * (k // 2) - k) // stride + 1
    flops = 2 * n * oh * oh * cout * k * k * cin
    x, w, y = n * h * h * cin, k * k * cin * cout, n * oh * oh * cout
    stem = ref.Conv("stem", 3, cin, 3, 1, True, h, h)
    p = ref.Plan(stem, (ref.Block((c,), None),), cout, 10, 1e-5)
    got = {cc.kind: cc for cc in counts.conv_costs(p, n, ("fwd", "dgrad", "wgrad"))
           if cc.name == "c"}
    for kind in ("fwd", "dgrad", "wgrad"):
        assert got[kind].flops == flops
        assert got[kind].bytes == 4 * (x + w + y)


def test_bound_takes_the_larger_side():
    cheap = counts.ConvCost("a", "fwd", flops=495e12, bytes=1.0)        # 1 s of products
    wide = counts.ConvCost("b", "fwd", flops=1.0, bytes=2 * 3.35e12)   # 2 s of bytes
    assert counts.bound_s([cheap, wide], 495e12, 3.35e12) == pytest.approx(3.0)


def _meta_flops(config, n, train):
    p = ref.plan(config)
    specs = ref.param_specs(p)
    leaves = [torch.empty(s[1], device="meta", requires_grad=train) for s in specs]
    x = torch.empty((n, config["input_hw"], config["input_hw"], 3), device="meta")
    y = torch.zeros((n,), dtype=torch.int64, device="meta")
    with FlopCounterMode(display=False) as fc:
        logits = ref.forward(p, dict(zip([s[0] for s in specs], leaves)), x)
        if train:
            torch.autograd.grad(ref.loss_fn(logits, y), leaves)
    return float(fc.get_total_flops())


@pytest.mark.parametrize("name,n,train", [
    ("resnet50-cifar100", 256, True), ("resnet18-cifar100", 512, True),
    ("resnet50-cifar100", 512, False)])
def test_step_flops_match_flop_counter(name, n, train):
    config = _config(name)
    assert counts.step_flops(ref.plan(config), n, train) == _meta_flops(config, n, train)


def test_costs_cover_every_convolution():
    p = ref.plan(_config("resnet50-cifar100"))
    sc = counts.cnn_step_costs(p, 8, train=True)
    assert len(sc.fwd) == len(p.convs()) == 53
    assert len(sc.bwd) == 2 * 53 - 1          # no dgrad for the stem
