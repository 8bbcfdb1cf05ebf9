"""Top-k gradient compression with error feedback (port of
``repro/optim/compression.py``).

Only the largest-|g| ``ratio`` fraction of each gradient tensor is
exchanged; the residual is accumulated locally into an f32 error-feedback
buffer and added back next step (Stich et al.-style memory), which
preserves convergence.  The threshold is the k-th largest |acc|
(``torch.topk``, k = max(1, int(size · ratio))) and every entry at or
above it is sent, ties included; leaves that are 0-d or of at most 8
entries pass whole.  For the same f32 inputs ``sent`` and ``err`` equal
the reference's exactly.
"""

from __future__ import annotations

import torch

from repro_torch.convert import tree_leaves, tree_map

__all__ = ["init_error_state", "compress_grads", "compression_stats"]


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _topk_mask(g: torch.Tensor, ratio: float) -> torch.Tensor:
    if g.ndim == 0 or g.numel() <= 8:
        return torch.ones_like(g, dtype=torch.bool)
    k = max(1, int(g.numel() * ratio))
    thresh = torch.topk(g.abs().reshape(-1), k).values[-1]
    return g.abs() >= thresh


@torch.no_grad()
def compress_grads(grads, error_state, *, ratio: float = 0.1):
    """Returns (sparse_grads, new_error_state).  sparse = dense tensor with
    (1-ratio) of entries zeroed, in the gradient's dtype."""
    errs = []

    def one(g, e):
        acc = g.float() + e
        sent = torch.where(_topk_mask(acc, ratio), acc, 0.0)
        errs.append(acc - sent)
        return sent.to(g.dtype)

    sent = tree_map(one, grads, error_state)
    it = iter(errs)             # tree_map visits the leaves in one order
    return sent, tree_map(lambda _: next(it), grads)


def compression_stats(grads, ratio: float) -> dict:
    total = sum(g.numel() for g in tree_leaves(grads))
    return {
        "dense_bytes": total * 4,
        "compressed_bytes": int(total * ratio) * (4 + 4),  # value + index
        "ratio": ratio,
    }
