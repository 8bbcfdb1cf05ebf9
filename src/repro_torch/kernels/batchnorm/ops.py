"""Public wrapper for BatchNorm with batch statistics and its activation
(no counterpart kernel in ``repro``: the reference's CNN leaves BatchNorm
to XLA).

The device of the tensors picks the path: a CUDA tensor goes to the Hopper
kernels (``kernel.batchnorm_cuda``) through one autograd Function, which
launches or raises; a CPU or meta tensor goes to the plain formula
(``ref.batchnorm_act_ref``) under autograd, so the CPU numerics and the
profiler's meta flop count are those of the eager ops.  There is no other
switch.  ``batchnorm_calls()`` gives the kernels' launches of each
direction beside the calls of the plain formula, so a run on the card can
show that every BatchNorm of a step took the kernels both ways.

The Function saves y (the convolution's output) and the per-channel mean
and rstd for its backward, and nothing else of full size: the backward
kernels recompute the normalised x and the activation's input from them
(``ref.batchnorm_act_backward_ref`` is the closed form they compute).
"""

from __future__ import annotations

import torch

from .kernel import batchnorm_cuda
from .ref import batchnorm_act_ref

__all__ = ["batchnorm_act", "batchnorm_calls"]

_plain_calls = 0


def batchnorm_calls() -> dict[str, int]:
    """BatchNorms so far in this process, by path: ``kernel`` and
    ``kernel_backward``, the forward and backward launches of the CUDA
    kernels (``batchnorm_cuda``'s counters), and ``plain``, the calls of
    :func:`batchnorm_act` on CPU and meta tensors."""
    return {"kernel": batchnorm_cuda.forward_launches,
            "kernel_backward": batchnorm_cuda.backward_launches,
            "plain": _plain_calls}


class _BatchNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale, shift, act):
        z, mean, rstd = batchnorm_cuda.forward(y, scale, shift, act)
        ctx.save_for_backward(y, scale, shift, mean, rstd)
        ctx.act = act
        return z

    @staticmethod
    def backward(ctx, dz):
        y, scale, shift, mean, rstd = ctx.saved_tensors
        dy, dscale, dshift = batchnorm_cuda.backward(dz.contiguous(), y, scale, shift,
                                                     mean, rstd, ctx.act)
        return dy, dscale, dshift, None


def batchnorm_act(y, scale, shift, act: str):
    """act(BatchNorm(y)) of NHWC y (N, H, W, C) with the batch's statistics
    (biased variance, eps 1e-5 inside the rsqrt) and the per-channel
    scale and shift, differentiable in all three; ``act`` is ``relu``,
    ``relu6`` or ``none``."""
    global _plain_calls
    if y.device.type == "cuda":
        return _BatchNormAct.apply(y.contiguous(), scale, shift, act)
    if y.device.type in ("cpu", "meta"):
        _plain_calls += 1
        return batchnorm_act_ref(y, scale, shift, act)
    raise ValueError(f"batchnorm_act: unsupported device {y.device}")
