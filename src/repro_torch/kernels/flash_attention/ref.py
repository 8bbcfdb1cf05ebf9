"""Plain PyTorch version of flash attention (port of
``repro/kernels/flash_attention/ref.py``).

``ops.flash_attention`` runs it for tensors on the CPU; on the card the
CUDA kernel computes the same function and ``chip_smoke.py`` holds the
two against each other.  Masked scores take the finite -1e30, so a row
with no visible key (``q_offset + i < 0`` under the causal mask) softmaxes
to uniform weights and returns the mean of V, in the reference too.
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "NEG_INF"]

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, scale=None, q_offset=0):
    """q: (B,H,Sq,Dh); k,v: (B,Hkv,Sk,Dh) → (B,H,Sq,Dh) in q's dtype.  f32
    softmax; GQA: query head h reads KV head h // (H/Hkv)."""
    B, H, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = H // Hkv
    kf = k.repeat_interleave(rep, dim=1).float()
    vf = v.repeat_interleave(rep, dim=1).float()
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kf)
    if causal:
        qp = q_offset + torch.arange(Sq, device=q.device)[:, None]
        kp = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(qp >= kp, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
