"""The benchmark's plain reference against the program on the CPU at a
small size (width 0.25, 16 x 16, batch 4): the forward's logits in f32,
and one training step's momentum and parameters in float64, where
BatchNorm's batch statistics leave no f32 rounding to hide a fault.

Besides the cells' ResNets, the inverted-residual networks of
``tests/configs/`` (MobileNetV2, and MnasNet for its 5 x 5 depthwise
layers), which no cell runs yet, at width 0.25: the logits at 64 x 64 and
batch 8 (at 32 x 32 and batch 4 the last BatchNorms normalise 4 numbers a
channel, and f32 rounding alone reads 4e-4 on either side against float64),
one step at 32 x 32 and batch 4."""

import json
import math
from pathlib import Path

import pytest
import torch

from perfbench.entries.cnn_common import CnnShape, draw_inputs, leaves_in_order, port_model, port_tree
from perfbench.reference import cnn as ref

from .conftest import small_cell, small_config

CONFIGS = ["resnet50-train-bs256", "resnet18-train-bs512"]
NETS = {"mobilenetv2-224-c100": 2351972, "mnasnet-224-c100": 3230412}


def net_config(name: str) -> dict:
    return json.loads((Path(__file__).parent / "configs" / f"{name}.json").read_text())


def _net_setup(name, dtype=torch.float32, seed=17, hw=32, bs=4):
    shape = CnnShape(small_config(net_config(name), hw=hw))
    leaves, x, y = draw_inputs(shape, {"batch_size": bs, "pool": 1}, seed, "cpu")
    leaves, x = [t.to(dtype) for t in leaves], x.to(dtype)
    return shape, port_model(shape.config), leaves, x, y


def _one_step(model, shape, leaves, x, y):
    """One SGD step of the program and of the reference from ``leaves``:
    ((loss, momentum, parameters) of the program, the same of the
    reference)."""
    from repro_torch.core.profiler import make_train_step

    params = port_tree(model, shape, [t.clone() for t in leaves])
    mom = port_tree(model, shape, [torch.zeros_like(t) for t in leaves])
    params, mom, loss = make_train_step(model)(params, mom, x, y)
    r_params = [t.clone() for t in leaves]
    r_mom = [torch.zeros_like(t) for t in leaves]
    r_loss, _ = ref.sgd_step(shape.plan, shape.names, r_params, r_mom, x, y,
                             lr=0.01, momentum=0.9)
    return ((loss, leaves_in_order(mom), leaves_in_order(params)),
            (r_loss, r_mom, [t.detach() for t in r_params]))


def _setup(workload, dtype=torch.float32, seed=11):
    cell = small_cell(workload)
    shape = CnnShape(cell.config)
    leaves, x, y = draw_inputs(shape, cell.traffic, seed, "cpu")
    leaves, x = [t.to(dtype) for t in leaves], x.to(dtype)
    return cell, shape, port_model(cell.config), leaves, x, y


@pytest.mark.parametrize("workload", CONFIGS)
def test_forward_logits_match_the_program(workload):
    cell, shape, model, leaves, x, _ = _setup(workload)
    got = model.apply(port_tree(model, shape, leaves), x[0])
    want = ref.forward(shape.plan, dict(zip(shape.names, leaves)), x[0])
    assert got.shape == want.shape == (4, 100)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4


@pytest.mark.parametrize("workload", CONFIGS)
def test_one_step_matches_the_program_in_float64(workload):
    cell, shape, model, leaves, x, y = _setup(workload, torch.float64)
    (loss, mom, params), (r_loss, r_mom, r_params) = _one_step(model, shape, leaves, x[0], y[0])
    assert float(loss) == pytest.approx(float(r_loss), rel=1e-12)
    for name, a, b in zip(shape.names, mom, r_mom):
        assert torch.allclose(a, b, rtol=1e-9, atol=1e-12), name
    for name, a, b in zip(shape.names, params, r_params):
        assert torch.allclose(a, b, rtol=1e-9, atol=1e-12), name


@pytest.mark.parametrize("name", NETS)
def test_inverted_residual_logits_match_the_program(name):
    shape, model, leaves, x, _ = _net_setup(name, hw=64, bs=8)
    assert any(c.groups > 1 for c in shape.plan.convs())
    got = model.apply(port_tree(model, shape, leaves), x[0])
    want = ref.forward(shape.plan, dict(zip(shape.names, leaves)), x[0])
    assert got.shape == want.shape == (8, 100)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4


@torch.no_grad()
def _leaf_gaps(names, got, want) -> dict[str, float]:
    """Each leaf's largest difference over the larger of that leaf's and the
    median leaf's largest magnitude (gradients of a shift that the next
    BatchNorm cancels are nought to rounding, and so is their gap)."""
    tops = [float(b.abs().max()) for b in want]
    med = sorted(tops)[len(tops) // 2]
    return {n: float((a - b).abs().max()) / max(t, med)
            for n, a, b, t in zip(names, got, want, tops)}


@pytest.mark.parametrize("name", NETS)
def test_inverted_residual_step_matches_the_program_in_float64(name):
    """Five stride-2 stages leave a 32 x 32 input 1 x 1, so the last
    BatchNorms see 4 numbers a channel and amplify float64's rounding
    elementwise: held by leaf, the gaps read at most 1.2e-11 (seeds 17-19),
    a misplaced activation or add reads 1e-3 or more."""
    shape, model, leaves, x, y = _net_setup(name, torch.float64)
    (loss, mom, params), (r_loss, r_mom, r_params) = _one_step(model, shape, leaves, x[0], y[0])
    assert float(loss) == pytest.approx(float(r_loss), rel=1e-12)
    for got, want in ((mom, r_mom), (params, r_params)):
        gaps = _leaf_gaps(shape.names, got, want)
        assert max(gaps.values()) < 1e-9, max(gaps, key=gaps.get)


@pytest.mark.parametrize("name,params", NETS.items())
def test_inverted_residual_full_width_parameters_match_the_program(name, params):
    """At 224 x 224 and width 1.0 the reference's leaves fit the program's
    tree leaf for leaf; depthwise weights are (k, k, 1, C)."""
    cfg = net_config(name)
    shape = CnnShape(cfg)
    assert sum(math.prod(s[1]) for s in shape.specs) == params == cfg["num_params"]
    dw = [s for s in shape.specs if s[0].endswith(".dw.w")]
    assert len(dw) == sum(st["blocks"] for st in cfg["stages"]) == 17
    assert all(s[1][2] == 1 and s[3] == s[1][0] ** 2 for s in dw)
    assert {s[1][0] for s in dw} == {st["k"] for st in cfg["stages"]}
    meta = [torch.empty(s[1], device="meta") for s in shape.specs]
    tree = port_tree(port_model(cfg), shape, meta)
    assert all(a is b for a, b in zip(leaves_in_order(tree), meta))


@pytest.mark.parametrize("workload,params", [("resnet50-train-bs256", 23705252),
                                             ("resnet18-train-bs512", 11220132)])
def test_full_width_parameters_match_the_program(workload, params):
    """The reference's leaves, in its order, fit the program's tree leaf
    for leaf (``port_tree`` checks every shape; meta tensors hold no data)."""
    from perfbench import spec

    cell = spec.resolve(workload)
    shape = CnnShape(cell.config)
    assert sum(math.prod(s[1]) for s in shape.specs) == params == cell.config["num_params"]
    meta = [torch.empty(s[1], device="meta") for s in shape.specs]
    tree = port_tree(port_model(cell.config), shape, meta)
    assert all(a is b for a, b in zip(leaves_in_order(tree), meta))


def test_inputs_repeat_from_the_seed():
    cell = small_cell("resnet50-train-bs256")
    shape = CnnShape(cell.config)
    a = draw_inputs(shape, cell.traffic, 2**31 + 12345, "cpu")
    b = draw_inputs(shape, cell.traffic, 2**31 + 12345, "cpu")
    c = draw_inputs(shape, cell.traffic, 2**31 + 12346, "cpu")
    assert all(torch.equal(p, q) for p, q in zip(a[0], b[0]))
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert not torch.equal(a[1], c[1])
    assert len({tuple(r.tolist()) for r in a[2]}) == cell.traffic["pool"]   # rows differ


def test_tf32_rounding_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-12, 1.0 + 2**-12, 3.0])
    got = ref._tf32(t)
    assert got.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 1.0, 3.0]
