"""The benchmark's flop and byte arithmetic against hand counts and
against PyTorch's ``FlopCounterMode`` on the meta device, and the ResNet
cells' plans and costs against the values they had before grouped
convolutions were counted."""

import hashlib
import json

import pytest
import torch
from torch.utils import flop_counter
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts
from perfbench.reference import cnn as ref
from perfbench.spec import HERE


def _config(name):
    """A cell's configuration, or one of ``tests/configs/``."""
    path = HERE / "configs" / f"{name}.json"
    if not path.exists():
        path = HERE / "tests" / "configs" / f"{name}.json"
    return json.loads(path.read_text())


@pytest.mark.parametrize("n,h,cin,cout,k,stride", [
    (2, 32, 64, 64, 3, 1),      # a ResNet 3x3
    (4, 16, 256, 64, 1, 1),     # a bottleneck's 1x1 reduction
    (3, 32, 256, 512, 1, 2),    # a strided projection shortcut
    (1, 32, 3, 64, 3, 1),       # the CIFAR stem
])
def test_conv_counts_by_hand(n, h, cin, cout, k, stride):
    c = ref.Conv("c", cin, cout, k, stride, "relu", h, h)
    oh = (h + 2 * (k // 2) - k) // stride + 1
    flops = 2 * n * oh * oh * cout * k * k * cin
    x, w, y = n * h * h * cin, k * k * cin * cout, n * oh * oh * cout
    stem = ref.Conv("stem", 3, cin, 3, 1, "relu", h, h)
    p = ref.Plan(stem, (ref.Block((c,), None),), cout, 10, 1e-5)
    got = {cc.kind: cc for cc in counts.conv_costs(p, n, ("fwd", "dgrad", "wgrad"))
           if cc.name == "c"}
    for kind in ("fwd", "dgrad", "wgrad"):
        assert got[kind].flops == flops
        assert got[kind].bytes == 4 * (x + w + y)


@pytest.mark.parametrize("n,h,c,k,stride", [
    (2, 56, 144, 3, 2),         # MobileNetV2's stride-2 depthwise 3x3 at 56x56
    (3, 14, 480, 5, 1),         # a MnasNet 5x5
])
def test_depthwise_counts_by_hand(n, h, c, k, stride):
    dw = ref.Conv("dw", c, c, k, stride, "relu6", h, h, groups=c)
    oh = (h + 2 * (k // 2) - k) // stride + 1
    flops = 2 * n * oh * oh * c * k * k           # one input channel a filter
    x, w, y = n * h * h * c, k * k * c, n * oh * oh * c
    stem = ref.Conv("stem", 3, c, 3, 1, "relu6", h, h)
    p = ref.Plan(stem, (ref.Block((dw,), None, add=False, act="none"),), c, 10, 1e-5)
    got = {cc.kind: cc for cc in counts.conv_costs(p, n, ("fwd", "dgrad", "wgrad"))
           if cc.name == "dw"}
    for kind in ("fwd", "dgrad", "wgrad"):
        assert got[kind].flops == flops
        assert got[kind].bytes == 4 * (x + w + y)
    sc = counts.cnn_step_costs(p, n, train=True)
    assert [cc.name for cc in sc.fwd] == ["stem"]           # conv_mm takes no groups
    assert sc.dw == tuple(got[kind] for kind in ("fwd", "dgrad", "wgrad"))
    assert [(cc.name, cc.kind) for cc in sc.bwd] == [("stem", "wgrad"), ("dw", "dgrad"),
                                                     ("dw", "wgrad")]
    assert counts.cnn_step_costs(p, n, train=False).dw == (got["fwd"],)


def test_bound_takes_the_larger_side():
    cheap = counts.ConvCost("a", "fwd", flops=495e12, bytes=1.0)        # 1 s of products
    wide = counts.ConvCost("b", "fwd", flops=1.0, bytes=2 * 3.35e12)   # 2 s of bytes
    assert counts.bound_s([cheap, wide], 495e12, 3.35e12) == pytest.approx(3.0)


def _backward_by_group(grad_out_shape, x_shape, w_shape, *args, out_shape=None, **kwargs):
    """``convolution_backward``'s flops: PyTorch's own count of the input
    gradient, and the weight gradient counted as the forward's products.
    PyTorch's formula reads no groups and counts a grouped convolution's
    weight gradient as a dense one's, ``groups`` times its products."""
    mask = args[7]
    dgrad = flop_counter.conv_backward_flop(grad_out_shape, x_shape, w_shape, *args[:7],
                                            [mask[0], False, False], out_val=out_shape)
    wgrad = flop_counter.conv_flop_count(x_shape, w_shape, grad_out_shape) if mask[1] else 0
    return dgrad + wgrad


def _meta_flops(config, n, train, mapping=None):
    p = ref.plan(config)
    specs = ref.param_specs(p)
    leaves = [torch.empty(s[1], device="meta", requires_grad=train) for s in specs]
    x = torch.empty((n, config["input_hw"], config["input_hw"], 3), device="meta")
    y = torch.zeros((n,), dtype=torch.int64, device="meta")
    with FlopCounterMode(display=False, custom_mapping=mapping or {}) as fc:
        logits = ref.forward(p, dict(zip([s[0] for s in specs], leaves)), x)
        if train:
            torch.autograd.grad(ref.loss_fn(logits, y), leaves)
    return float(fc.get_total_flops())


@pytest.mark.parametrize("name,n,train", [
    ("resnet50-cifar100", 256, True), ("resnet18-cifar100", 512, True),
    ("resnet50-cifar100", 512, False), ("mobilenetv2-224-c100", 256, True),
    ("mobilenetv2-224-c100", 256, False), ("mnasnet-224-c100", 64, True)])
def test_step_flops_match_flop_counter(name, n, train):
    config = _config(name)
    p = ref.plan(config)
    by_group = {torch.ops.aten.convolution_backward: _backward_by_group}
    assert counts.step_flops(p, n, train) == _meta_flops(config, n, train, by_group)
    # PyTorch's own formula counts (groups - 1) times each grouped weight
    # gradient's products too many, and nothing else differs
    extra = sum((c.groups - 1) * counts.conv_costs(p, n)[i].flops
                for i, c in enumerate(p.convs())) if train else 0.0
    assert counts.step_flops(p, n, train) + extra == _meta_flops(config, n, train)


@pytest.mark.parametrize("name,convs,grouped", [("resnet50-cifar100", 53, 0),
                                                 ("mobilenetv2-224-c100", 52, 17)])
def test_costs_cover_every_convolution(name, convs, grouped):
    p = ref.plan(_config(name))
    sc = counts.cnn_step_costs(p, 8, train=True)
    assert len(p.convs()) == convs
    assert len(sc.fwd) == convs - grouped
    assert len(sc.bwd) == 2 * convs - 1          # no dgrad for the stem
    assert len(sc.dw) == 3 * grouped
    dense = 3 * 2.0 * 8 * p.dense_in * p.dense_out
    fwd = sc.fwd + tuple(c for c in sc.dw if c.kind == "fwd")
    assert counts.step_flops(p, 8, True) == pytest.approx(
        sum(c.flops for c in fwd + sc.bwd) + dense)


def _conv_row(c):
    return (c.name, c.cin, c.cout, c.k, c.stride, c.act, c.h, c.w, c.groups)


def _digest(value) -> str:
    return hashlib.sha256(repr(value).encode()).hexdigest()[:16]


# sha256 of the plans, parameter lists and step costs of the ResNet
# configurations as they were before grouped convolutions, relu6 and
# inverted residuals came into the reference (a plan's ReLU flag read as
# "relu" or "none", every group 1)
RESNET_DIGESTS = {
    "resnet50-cifar100": {"plan": "a1e450c7c1ccb389", "specs": "15319b3720856380",
                          "costs256True": "ffec9232792eeab5", "costs512True": "82426dcb7ac616e9",
                          "costs512False": "06f37abb9d977e28"},
    "resnet18-cifar100": {"plan": "fd33f6a6ab09055d", "specs": "ecc7f3383e7c1620",
                          "costs256True": "69925ec553670904", "costs512True": "846951d3eaf4bff8",
                          "costs512False": "259d16bdd84db1bf"},
}


@pytest.mark.parametrize("name", sorted(RESNET_DIGESTS))
def test_resnet_plans_and_costs_are_unchanged(name):
    p = ref.plan(_config(name))
    rows = [_conv_row(c) for c in p.convs()] + [
        [(tuple(_conv_row(c) for c in b.body), b.shortcut and _conv_row(b.shortcut))
         for b in p.blocks], p.dense_in, p.dense_out, p.eps]
    got = {"plan": _digest(rows), "specs": _digest(ref.param_specs(p))}
    for n, train in ((256, True), (512, True), (512, False)):
        sc = counts.cnn_step_costs(p, n, train)
        assert sc.dw == ()
        got[f"costs{n}{train}"] = _digest((sc.step_flops, sc.fwd, sc.bwd))
    assert got == RESNET_DIGESTS[name]
    assert all(b.add and b.act == "relu" for b in p.blocks) and p.head is None
