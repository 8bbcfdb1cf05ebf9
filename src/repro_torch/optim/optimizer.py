"""Optimizers: AdamW and SGD-momentum, with global-norm clipping and a
warm-up + cosine schedule (port of ``repro/optim/optimizer.py``).

The functions take a tree of tensors — a dict (nested or flat, such as
``dict(model.named_parameters())``), a list or a tuple — and the state
mirrors it: f32 slots ``m`` (and ``v`` for AdamW) and an int32 0-d
``step``.  The reference's numerics are kept where a port silently
drifts: ``lr`` and the bias corrections ``1 - b**step`` are f32 tensors;
clipped gradients are cast back to the gradient's dtype before ``m`` and
``v`` read them; weight decay is added to the update of every leaf; the
new parameters are rounded back to the parameter dtype.

On a mesh every leaf is a ``DTensor``: each gradient is first laid out as
its slot (``_placed_like``: a reduce-scatter onto the ZeRO slots), and the
in-place writes keep every leaf's placements.

Where the reference returns new arrays, ``apply_updates`` writes the
parameters and the slots in place (the arrays a jit would donate) and
returns the same objects, so a full-width step holds one copy of the
state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.convert import tree_leaves, tree_map

__all__ = ["OptimizerConfig", "init_opt_state", "apply_updates", "cosine_schedule",
           "global_norm", "clip_by_global_norm"]


@dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"          # adamw | sgdm
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9        # sgdm
    clip_norm: float | None = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warm-up to ``lr``, then half a cosine to 0 at
    ``total_steps``; an f32 0-d tensor (on ``step``'s device)."""
    step = (step.float() if torch.is_tensor(step)
            else torch.tensor(step, dtype=torch.float32))
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to at most ``max_norm``, cast back to their dtype;
    the global norm before clipping)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def init_opt_state(params, cfg: OptimizerConfig) -> dict:
    """f32 slots on each parameter's device.  AdamW: m, v; SGD-m: m only.
    ``step`` is an int32 0-d tensor."""
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    state: dict = {"step": torch.zeros((), dtype=torch.int32, device=device),
                   "m": tree_map(f32, params)}
    if cfg.kind == "adamw":
        state["v"] = tree_map(f32, params)
    return state


def _placed_like(g, m):
    """The gradient laid out as its slot: on a mesh (DTensors), a partial
    or replicated gradient reduced or sliced to the slot's placements
    (ZeRO's reduce-scatter) before the update combines them; plain
    tensors as they are."""
    placements = getattr(m, "placements", None)
    if placements is None or getattr(g, "placements", placements) == placements:
        return g
    return g.redistribute(m.device_mesh, placements)


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: OptimizerConfig):
    """Returns (params, opt_state, metrics), the first two updated in place."""
    if cfg.kind not in ("adamw", "sgdm"):
        raise ValueError(cfg.kind)
    metrics = {}
    if cfg.clip_norm is not None:
        grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
        metrics["grad_norm"] = gn
    step = opt_state["step"] + 1
    lr = cosine_schedule(cfg, step)
    metrics["lr"] = lr

    if cfg.kind == "adamw":
        b1, b2 = cfg.beta1, cfg.beta2
        c1 = 1.0 - torch.pow(b1, step.float())
        c2 = 1.0 - torch.pow(b2, step.float())

        def upd(p, g, m, v):
            g = _placed_like(g, m).float()
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            u = u + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * u).to(p.dtype))

        tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
        opt_state.update(step=step)
        return params, opt_state, metrics

    def upd_sgdm(p, g, m):
        g = _placed_like(g, m)
        m.copy_(cfg.momentum * m + g.float())
        p.copy_((p.float() - lr * m).to(p.dtype))

    tree_map(upd_sgdm, params, grads, opt_state["m"])
    opt_state.update(step=step)
    return params, opt_state, metrics
