"""The benchmark's plain reference against the program on the CPU at a
small size (width 0.25, 16 x 16, batch 4): the forward's logits in f32,
and one training step's momentum and parameters in float64, where
BatchNorm's batch statistics leave no f32 rounding to hide a fault."""

import math

import pytest
import torch

from perfbench.entries.cnn_common import CnnShape, draw_inputs, leaves_in_order, port_model, port_tree
from perfbench.reference import cnn as ref

from .conftest import small_cell

CONFIGS = ["resnet50-train-bs256", "resnet18-train-bs512"]


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
    from repro_torch.core.profiler import make_train_step

    cell, shape, model, leaves, x, y = _setup(workload, torch.float64)
    params = port_tree(model, shape, [t.clone() for t in leaves])
    mom = port_tree(model, shape, [torch.zeros_like(t) for t in leaves])
    params, mom, loss = make_train_step(model)(params, mom, x[0], y[0])
    r_params = [t.clone() for t in leaves]
    r_mom = [torch.zeros_like(t) for t in leaves]
    r_loss, _ = ref.sgd_step(shape.plan, shape.names, r_params, r_mom, x[0], y[0],
                             lr=0.01, momentum=0.9)
    assert float(loss) == pytest.approx(float(r_loss), rel=1e-12)
    for name, a, b in zip(shape.names, leaves_in_order(mom), r_mom):
        assert torch.allclose(a, b, rtol=1e-9, atol=1e-12), name
    for name, a, b in zip(shape.names, leaves_in_order(params), r_params):
        assert torch.allclose(a, b.detach(), rtol=1e-9, atol=1e-12), name


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
