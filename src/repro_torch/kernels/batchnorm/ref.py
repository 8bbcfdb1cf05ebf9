"""Plain PyTorch versions of BatchNorm with batch statistics and its
activation, over NHWC.

``batchnorm_act_ref`` is the CNN's formula as it stands (the reference's
``C.apply`` in ``repro/models/cnn.py``): ``ops.batchnorm_act`` runs it for
CPU and meta tensors, under autograd, so the CPU numerics and the meta flop
count are those of the eager ops.  ``batchnorm_act_forward_ref`` and
``batchnorm_act_backward_ref`` are the plain version of what the CUDA
kernels compute (``csrc/batchnorm.cu``): the forward's statistics and the
closed-form backward, which saves only y, mean and rstd.  The tests hold
the closed form against autograd of the formula, and ``chip_smoke.py`` and
the card tests hold the kernels against both.
"""

from __future__ import annotations

import torch

__all__ = ["ACTS", "EPS", "activation", "batchnorm_act_ref", "batchnorm_act_forward_ref",
           "batchnorm_act_backward_ref"]

ACTS = ("none", "relu", "relu6")    # in the kernels' order of codes
EPS = 1e-5
_DIMS = (0, 1, 2)


def activation(x, kind: str):
    if kind == "relu":
        return torch.relu(x)
    if kind == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if kind == "none":
        return x
    raise ValueError(kind)


def batchnorm_act_ref(y, scale, shift, act: str):
    """act(BatchNorm(y)) of NHWC y with the batch's statistics: the biased
    variance, eps inside the rsqrt, the mean first and the variance
    centred."""
    mu = y.mean(dim=_DIMS, keepdim=True)
    var = y.var(dim=_DIMS, unbiased=False, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + EPS)
    return activation(y * scale + shift, act)


def batchnorm_act_forward_ref(y, scale, shift, act: str):
    """(z, mean, rstd) as the kernels' forward returns them: z is
    ``batchnorm_act_ref``, mean and rstd are per channel."""
    mean = y.mean(dim=_DIMS)
    rstd = torch.rsqrt(y.var(dim=_DIMS, unbiased=False) + EPS)
    z = activation(((y - mean) * rstd) * scale + shift, act)
    return z, mean, rstd


def _mask(dz, p, act: str):
    if act == "relu":
        return torch.where(p > 0, dz, 0.0)
    if act == "relu6":
        return torch.where((p > 0) & (p < 6), dz, 0.0)
    if act == "none":
        return dz
    raise ValueError(act)


def batchnorm_act_backward_ref(dz, y, scale, shift, mean, rstd, act: str):
    """(dy, dscale, dshift) of ``batchnorm_act_ref`` at dz in closed form,
    from y and the forward's per-channel mean and rstd: x = (y − mean)·rstd
    and p = x·scale + shift recomputed, dz′ = dz masked by the activation's
    derivative, dshift = Σdz′, dscale = Σdz′·x and
    dy = scale·rstd·(dz′ − (dshift + x·dscale)/M)."""
    M = y.numel() // y.shape[-1]
    x = (y - mean) * rstd
    dzp = _mask(dz, x * scale + shift, act)
    dshift = dzp.sum(dim=_DIMS)
    dscale = (dzp * x).sum(dim=_DIMS)
    dy = scale * rstd * (dzp - (dshift + x * dscale) / M)
    return dy, dscale, dshift
