"""Carry parameters between the reference's numpy tree and the port's
modules (no counterpart in ``repro``).

CNN parameters (``repro.models.cnn.CNNModel.init``, which the port's
``CNNModel.init`` draws identically) are a nested dict of numpy arrays
with HWIO conv weights; the port's ``apply`` takes the same dict with
tensor leaves, so :func:`cnn_params_from_numpy` and
:func:`cnn_params_to_numpy` copy leaf by leaf and keep the layout.

``repro.models.transformer.init_params`` returns a nested dict of numpy
arrays whose block (and encoder) leaves are stacked on a leading
``(n_scan, …)`` axis; the port keeps one scan step per entry of
``blocks`` (a :class:`~repro_torch.models.transformer.Block`, or a
superblock of them) and one Block per encoder layer, named by
:func:`~repro_torch.models.transformer.param_name`.  Both keep ``(in,
out)`` weights used as ``x @ W``, so conversion is a copy that unstacks
(or restacks) the scan axis.  Arrays are read
through ``np.asarray(leaf, np.float32)``, which is exact for the
reference's bf16 leaves; tensors are copied as they are.

A training state carries the same layout: the reference's
``{"params", "opt": {"step", "m", "v"}, "err"}`` holds the slots as
parameter trees, the port's (``repro_torch.train.trainer``) an
:class:`~repro_torch.models.transformer.LM` and the slots as dicts keyed
by the model's parameter names (``blocks.3.attn.wq``).
:func:`train_state_to_tree` restacks a port state into the reference's
tree with tensor leaves (what the checkpoint writes),
:func:`train_state_from_jax` unstacks one into a port state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import LM, param_leaves, param_name

__all__ = ["params_from_jax", "params_to_numpy", "grads_to_numpy",
           "train_state_from_jax", "train_state_to_tree", "train_state_to_numpy",
           "cnn_params_from_numpy", "cnn_params_to_numpy", "tree_map", "tree_leaves"]


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _stacked(path: tuple[str, ...]) -> bool:
    return path[0] in ("blocks", "encoder")


def _host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of ``t``, detached; a ``DTensor`` gathered whole first
    (a collective: every rank calls it)."""
    full = getattr(t, "full_tensor", None)
    return (full() if full is not None else t).detach().cpu()


def _restack(named: dict, cfg: ArchConfig) -> dict:
    """Tensors keyed by parameter name → the reference's tree, block and
    encoder leaves stacked on the scan axis; CPU tensors in their own
    dtypes (a ``DTensor`` gathered whole)."""
    tree: dict = {}
    for path, shape in param_leaves(cfg):
        if _stacked(path):
            leaf = torch.stack([_host(named[param_name(cfg, path, layer)])
                                for layer in range(shape[0])])
        else:
            leaf = _host(named[param_name(cfg, path)])
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


@torch.no_grad()
def _unstack(tree, cfg: ArchConfig, named: dict) -> None:
    """Copy the reference's tree (numpy, JAX or tensor leaves) into the
    tensors keyed by parameter name, one scan-step slice at a time."""
    for path, shape in param_leaves(cfg):
        leaf = _get(tree, path)
        if not torch.is_tensor(leaf):
            leaf = torch.from_numpy(np.asarray(leaf, np.float32))
        if tuple(leaf.shape) != tuple(shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(leaf.shape)} != "
                             f"{tuple(shape)}")
        for layer in range(shape[0]) if _stacked(path) else [None]:
            named[param_name(cfg, path, layer)].copy_(
                leaf if layer is None else leaf[layer])


def _numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.is_floating_point() else t).numpy()


def params_from_jax(tree, cfg: ArchConfig, *, device="cuda",
                    dtype=torch.bfloat16) -> LM:
    """The reference's parameter tree (numpy leaves) → an :class:`LM`."""
    model = LM(cfg, dtype=dtype, device=device)
    _unstack(tree, cfg, dict(model.named_parameters()))
    return model


def params_to_numpy(model: LM, cfg: ArchConfig) -> dict:
    """An :class:`LM` → the reference's tree layout, float32 numpy leaves
    (block and encoder leaves restacked on the scan axis)."""
    return tree_map(_numpy, _restack(dict(model.named_parameters()), cfg))


def grads_to_numpy(model: LM, cfg: ArchConfig) -> dict:
    """The model's ``.grad`` tensors in the layout of the reference's
    gradient tree, float32 numpy leaves."""
    return tree_map(_numpy, _restack(
        {n: p.grad for n, p in model.named_parameters()}, cfg))


def train_state_to_tree(state: dict, cfg: ArchConfig) -> dict:
    """A port training state → the reference's state tree, CPU tensor
    leaves in their own dtypes (bf16 parameters, f32 slots, int32 step)."""
    opt = state["opt"]
    tree = {"params": _restack(dict(state["params"].named_parameters()), cfg),
            "opt": {"step": _host(opt["step"]),
                    **{k: _restack(opt[k], cfg) for k in ("m", "v") if k in opt}}}
    if "err" in state:
        tree["err"] = _restack(state["err"], cfg)
    return tree


def train_state_to_numpy(state: dict, cfg: ArchConfig) -> dict:
    """:func:`train_state_to_tree` with numpy leaves: float32, and the
    int32 step."""
    return tree_map(_numpy, train_state_to_tree(state, cfg))


def train_state_from_jax(tree: dict, cfg: ArchConfig, *, device="cuda",
                         dtype=torch.bfloat16) -> dict:
    """The reference's state tree (numpy, JAX or tensor leaves: a
    reference ``Trainer`` state or a restored checkpoint) → a port state
    on ``device``: the parameters in ``dtype``, the slots f32, ``step``
    int32."""
    model = params_from_jax(tree["params"], cfg, device=device, dtype=dtype)
    dev = next(model.parameters()).device

    def slots(sub):
        named = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                 for n, p in model.named_parameters()}
        _unstack(sub, cfg, named)
        return named

    step = tree["opt"]["step"]
    step = (step if torch.is_tensor(step) else torch.from_numpy(np.asarray(step)))
    state = {"params": model,
             "opt": {"step": step.to(device=dev, dtype=torch.int32),
                     **{k: slots(tree["opt"][k]) for k in ("m", "v")
                        if k in tree["opt"]}}}
    if "err" in tree:
        state["err"] = slots(tree["err"])
    return state


def tree_map(fn, tree, *rest):
    """``fn`` applied to every leaf of nested dicts, lists and tuples, and
    to the leaves at the same place in the trees ``rest`` of the same
    structure (dicts by key, lists and tuples by position)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


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
