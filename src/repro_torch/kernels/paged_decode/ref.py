"""Plain PyTorch version of paged single-query decode attention (port of
``repro/kernels/paged_decode/ref.py`` and of ``combine_splits`` in
``repro/kernels/paged_decode/kernel.py``).

The wrapper in ``ops.py`` runs it for tensors on the CPU; on the card the
CUDA kernel computes the same function and ``chip_smoke.py`` holds the
two against each other.  Key positions run over the *logical* gathered
view ``NB·bs``; position ``k`` is attended iff ``k <= cache_len[b]`` —
the freshly scattered token at ``cache_len`` included, everything beyond
(junk blocks, scratch padding) masked out.
"""

from __future__ import annotations

import math

import torch

__all__ = ["paged_decode_ref", "combine_splits", "NEG_INF"]

NEG_INF = -1e30


def paged_decode_ref(q, k_pool, v_pool, block_table, cache_len, *,
                     scale: float | None = None):
    """q: (B, H, Dh); k/v_pool: (P, bs, Hkv, Dh); block_table: (B, NB)
    int32; cache_len: (B,) int32 → (B, H, Dh) in q's dtype.

    ``cache_len[b]`` is row b's highest valid logical position, so
    ``cache_len[b] + 1`` keys are attended.  GQA: consecutive groups of
    ``H // Hkv`` query heads share one KV head.
    """
    B, H, Dh = q.shape
    bs, Hkv = k_pool.shape[1], k_pool.shape[2]
    NB = block_table.shape[1]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)

    bt = block_table.long()
    k = k_pool[bt].reshape(B, NB * bs, Hkv, Dh).float()
    v = v_pool[bt].reshape(B, NB * bs, Hkv, Dh).float()
    qr = (q.float() * scale).reshape(B, Hkv, rep, Dh)

    s = torch.einsum("bgrd,bkgd->bgrk", qr, k)             # (B, Hkv, rep, L)
    pos = torch.arange(NB * bs, device=q.device)
    valid = pos[None, :] <= cache_len.long()[:, None]      # (B, L)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrk,bkgd->bgrd", p, v)
    return o.reshape(B, H, Dh).to(q.dtype)


def combine_splits(acc, m, l, out_dtype):
    """Merge per-split partials: acc/m/l are (B, Hkv, n_splits, rep[, Dh])
    f32 → (B, H, Dh).  Dead splits carry (acc=0, m=NEG_INF, l=0) and
    vanish under the global-max renormalisation (NEG_INF is finite, so
    the exp underflows to exactly 0 instead of producing NaN)."""
    B, Hkv, n_splits, rep, Dh = acc.shape
    m_g = m.amax(dim=2, keepdim=True)                      # (B, Hkv, 1, rep)
    w = torch.exp(m - m_g)                                 # (B, Hkv, s, rep)
    l_g = (w * l).sum(dim=2)                               # (B, Hkv, rep)
    o = (w[..., None] * acc).sum(dim=2)                    # (B, Hkv, rep, Dh)
    l_g = torch.where(l_g == 0.0, 1.0, l_g)  # fully-masked rows (idle slots)
    return (o / l_g[..., None]).reshape(B, Hkv * rep, Dh).to(out_dtype)
