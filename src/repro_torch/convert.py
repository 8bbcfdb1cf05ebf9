"""Carry parameters between the reference's numpy tree and the port's
modules (no counterpart in ``repro``).

CNN parameters (``repro.models.cnn.CNNModel.init``, which the port's
``CNNModel.init`` draws identically) are a nested dict of numpy arrays
with HWIO conv weights; the port's ``apply`` takes the same dict with
tensor leaves, so :func:`cnn_params_from_numpy` and
:func:`cnn_params_to_numpy` copy leaf by leaf and keep the layout.

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
from repro_torch.device import resolve_device
from repro_torch.models.transformer import LM, param_leaves, param_of

__all__ = ["params_from_jax", "params_to_numpy", "cnn_params_from_numpy",
           "cnn_params_to_numpy", "tree_map", "tree_leaves"]


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


def tree_map(fn, tree):
    """``fn`` applied to every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts (in sorted-key order, as JAX flattens
    them, so two dicts with the same keys line up whatever order their
    keys were inserted in), lists and tuples."""
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def cnn_params_from_numpy(tree: dict, *, device="cuda") -> dict:
    """A CNN parameter dict with numpy leaves → the same dict with float32
    tensor leaves on ``device`` (copies; the numpy arrays are not shared)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=dev), tree)


def cnn_params_to_numpy(params: dict) -> dict:
    """The inverse of :func:`cnn_params_from_numpy`: float32 numpy leaves."""
    return tree_map(lambda t: t.detach().float().cpu().numpy(), params)
