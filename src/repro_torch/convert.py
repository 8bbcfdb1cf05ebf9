"""Carry parameters between the reference's numpy tree and the port's
modules (no counterpart in ``repro``).

``repro.models.transformer.init_params`` returns a nested dict of numpy
arrays whose block leaves are stacked on a leading ``(n_layers, …)`` axis;
the port keeps one :class:`~repro_torch.models.transformer.Block` per
layer.  Both keep ``(in, out)`` weights used as ``x @ W``, so conversion
is a copy that unstacks (or restacks) the layer axis.  Arrays are read
through ``np.asarray(leaf, np.float32)``, which is exact for the
reference's bf16 leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import LM, param_leaves, param_of

__all__ = ["params_from_jax", "params_to_numpy"]


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@torch.no_grad()
def params_from_jax(tree, cfg: ArchConfig, *, device="cuda",
                    dtype=torch.bfloat16) -> LM:
    """The reference's parameter tree (numpy leaves) → an :class:`LM`."""
    model = LM(cfg, dtype=dtype, device=device)
    for path, shape in param_leaves(cfg):
        leaf = np.asarray(_get(tree, path), np.float32)
        if leaf.shape != tuple(shape):
            raise ValueError(f"{'/'.join(path)}: shape {leaf.shape} != "
                             f"{tuple(shape)}")
        if path[0] == "blocks":
            for layer in range(shape[0]):
                param_of(model, path, layer).copy_(torch.from_numpy(leaf[layer]))
        else:
            param_of(model, path).copy_(torch.from_numpy(leaf))
    return model


@torch.no_grad()
def params_to_numpy(model: LM, cfg: ArchConfig) -> dict:
    """An :class:`LM` → the reference's tree layout, float32 numpy leaves
    (block leaves restacked on the layer axis)."""
    tree: dict = {}
    for path, shape in param_leaves(cfg):
        if path[0] == "blocks":
            leaf = np.stack([param_of(model, path, layer).float().cpu().numpy()
                             for layer in range(shape[0])])
        else:
            leaf = param_of(model, path).float().cpu().numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree
