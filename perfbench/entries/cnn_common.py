"""What the CNN entries share: the program's model for a configuration, the
inputs drawn from the seed, and the program's parameter tree filled with
them.

Inputs, from one ``torch.Generator`` on the device seeded with ``--seed``,
in this order: every He-normal weight in one draw (std sqrt(2 / fan_in)
per leaf), then the pool of batches, ``x`` ~ N(0, 1) in NHWC and labels
uniform over the classes (int32).  BatchNorm scales are 1, shifts and the
``Dense`` bias 0.  Drawing again with the same seed gives the same
tensors, which is how the reference gets the same inputs as the program.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import cnn as ref

__all__ = ["port_model", "draw_inputs", "port_tree", "leaves_in_order", "CnnShape"]


class CnnShape:
    """The configuration's network as the reference builds it."""

    def __init__(self, config: dict):
        if config["dtype"] != "float32":
            raise ValueError(f"the CNN entries run float32, not {config['dtype']}")
        self.config = config
        self.plan = ref.plan(config)
        self.specs = ref.param_specs(self.plan)
        self.names = [s[0] for s in self.specs]


def port_model(config: dict):
    """The program's model for ``config`` (``port_builder`` of
    ``repro_torch.models.cnn`` at the configuration's width and input)."""
    from repro_torch.models import cnn

    model = getattr(cnn, config["port_builder"])(
        width_mult=config["width_mult"], input_hw=config["input_hw"])
    if model.num_classes != config["num_classes"]:
        raise ValueError(f"{config['name']}: the program's model has "
                         f"{model.num_classes} classes, the configuration "
                         f"{config['num_classes']}")
    return model


def draw_inputs(shape: CnnShape, traffic: dict, seed: int, device):
    """(leaves in the reference's order, x pool (P, N, H, W, C), y pool
    (P, N)) drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    he = [s for s in shape.specs if s[2] == "he"]
    sizes = [int(np.prod(s[1])) for s in he]
    std = torch.tensor([(2.0 / s[3]) ** 0.5 for s in he], device=device)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(torch.repeat_interleave(std, torch.tensor(sizes, device=device)))
    drawn = iter(torch.split(flat, sizes))
    leaves = []
    for _, dims, init, _ in shape.specs:
        if init == "he":
            leaves.append(next(drawn).view(dims).clone())
        elif init == "ones":
            leaves.append(torch.ones(dims, device=device))
        else:
            leaves.append(torch.zeros(dims, device=device))
    del flat, drawn
    cfg, n, pool = shape.config, traffic["batch_size"], traffic["pool"]
    hw = cfg["input_hw"]
    x = torch.randn((pool, n, hw, hw, cfg["in_channels"]), generator=gen, device=device)
    y = torch.randint(0, cfg["num_classes"], (pool, n), generator=gen, device=device,
                      dtype=torch.int32)
    return leaves, x, y


class _Shapes:
    """Stands in for the numpy generator that ``model.init`` hands its
    graph: zeros of the asked shape, so that the tree's structure comes
    without a draw."""

    @staticmethod
    def standard_normal(size):
        return np.zeros(size, np.float32)


def leaves_in_order(tree) -> list:
    """The leaves of nested dicts in insertion order (the order the
    program's graph runs its layers)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves_in_order(v)]
    return [tree]


def _fill(tree, it):
    if isinstance(tree, dict):
        return {k: _fill(v, it) for k, v in tree.items()}
    return next(it)


def port_tree(model, shape: CnnShape, leaves: list[torch.Tensor]) -> dict:
    """The program's parameter tree (structure from the model's graph) holding
    ``leaves``, which are in the reference's order; each leaf's shape is
    checked against the tree's."""
    structure = model.graph.init(_Shapes(), (model.input_hw, model.input_hw, 3))
    slots = leaves_in_order(structure)
    if len(slots) != len(leaves):
        raise ValueError(f"the program's tree has {len(slots)} leaves, the "
                         f"reference {len(leaves)}")
    for (name, *_), slot, leaf in zip(shape.specs, slots, leaves):
        if tuple(slot.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: the program's leaf is {tuple(slot.shape)}, "
                             f"the reference's {tuple(leaf.shape)}")
    return _fill(structure, iter(leaves))
