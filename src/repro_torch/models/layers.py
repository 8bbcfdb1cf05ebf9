"""Transformer building blocks in PyTorch (port of ``repro/models/layers.py``).

This slice ports what a dense self-attention stack needs: ``rms_norm``,
``rope``, ``_mask_bias``, ``blocked_attention``, ``attention_block`` (no
cache, dense cache and paged pool) and ``mlp_block``, plus the parameter
modules ``Attention`` and ``MLP``.  Cross-attention, ``moe_block`` and
``ssd_block`` come with later slices.

Parameters keep the JAX layout: ``(in, out)`` weights used as ``x @ W``.
Caches are updated in place (``index_put_`` / slice assignment) where the
JAX package returns a new buffer that the jit donates; ``attention_block``
still returns ``(out, cache)`` with the same cache object.

A decode step (S == 1, causal) over the paged pool always goes through
:func:`repro_torch.kernels.paged_decode.paged_decode_attention`: the CUDA
kernel for tensors on the card, its plain version for CPU tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.autotune import largest_dividing_block
from repro_torch.kernels.paged_decode import paged_decode_attention

__all__ = [
    "Attention",
    "MLP",
    "rms_norm",
    "rope",
    "blocked_attention",
    "attention_block",
    "mlp_block",
]

_NEG_INF = -1e30


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    """wq (D, H·Dh), wk/wv (D, Hkv·Dh), wo (H·Dh, D) [+ q_norm/k_norm (Dh,),
    bq/bk/bv]."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        self.wq = _param((D, H * Dh), dtype, device)
        self.wk = _param((D, Hkv * Dh), dtype, device)
        self.wv = _param((D, Hkv * Dh), dtype, device)
        self.wo = _param((H * Dh, D), dtype, device)
        if cfg.qk_norm:
            self.q_norm = _param((Dh,), dtype, device)
            self.k_norm = _param((Dh,), dtype, device)
        if cfg.attn_bias:
            self.bq = _param((H * Dh,), dtype, device)
            self.bk = _param((Hkv * Dh,), dtype, device)
            self.bv = _param((Hkv * Dh,), dtype, device)


class MLP(nn.Module):
    """SwiGLU: gate/up (D, F), down (F, D)."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        D, Ff = cfg.d_model, cfg.d_ff
        self.gate = _param((D, Ff), dtype, device)
        self.up = _param((D, Ff), dtype, device)
        self.down = _param((Ff, D), dtype, device)


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope(x, positions, theta: float):
    """Rotary embedding over split halves.  x: (..., S, H, Dh),
    positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _mask_bias(q_pos, k_pos, kind: str, chunk: int, prefix: int, kv_len=None):
    """Additive mask bias (0 or -1e30), f32.

    q_pos: (Sq,) or (B, Sq); k_pos: (Sk,) or (B, Sk) — leading batch dims
    broadcast, so ragged (per-row) positions yield a (B, Sq, Sk) bias.
    Negative key positions mark left-padding slots and are always masked
    out.  ``kv_len`` may be a scalar or a per-row (B,) vector (inclusive).
    """
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    if kind == "causal":
        ok = k <= q
    elif kind == "chunked":  # causal within a local chunk window
        ok = (k <= q) & (q - k < chunk) & (q // chunk == k // chunk)
    elif kind == "prefix":   # bidirectional over first `prefix`, causal after
        ok = (k <= q) | (k < prefix)
    elif kind == "full":
        ok = torch.ones_like(k <= q)
    else:
        raise ValueError(kind)
    if kind != "full":
        ok = ok & (k >= 0)  # left-padding slots carry negative positions
    if kv_len is not None:  # decode: only attend to valid cache entries
        kv = torch.as_tensor(kv_len, device=ok.device)
        if kv.ndim:
            kv = kv[..., None, None]
        ok = ok & (k <= kv)
    return torch.where(ok, 0.0, _NEG_INF).float()


def blocked_attention(
    q, k, v, *,
    q_positions, k_positions,
    mask_kind: str = "causal",
    chunk: int = 8192,
    prefix: int = 0,
    kv_len=None,
    block_q: int | None = None,
    scale: float | None = None,
):
    """GQA attention in query blocks (bounds the score tensor).

    q: (B, Sq, H, Dh);  k, v: (B, Sk, Hkv, Dh).  Returns (B, Sq, H, Dh) in
    v's dtype.  Scores are f32 (JAX's ``preferred_element_type``); the
    probabilities are cast to v's dtype before the PV product, as in the
    reference.  ``block_q=None`` takes the flash-attention tiling default
    of the reference, the largest divisor of Sq that is ≤ 512.
    """
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qr = (q * scale).reshape(B, Sq, Hkv, rep, Dh)
    if block_q is None:
        block_q = largest_dividing_block(Sq, 512)
    kf = k.float()

    def one_block(qblk, qpos):
        bias = _mask_bias(qpos, k_positions, mask_kind, chunk, prefix, kv_len)
        if bias.ndim == 3:   # (B, Sq, Sk) per-row bias → broadcast over (G, R)
            bias = bias[:, None, None]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qblk.float(), kf) + bias
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return torch.einsum("bgrqk,bkgd->bqgrd", p, v)

    outs = [one_block(qr[:, i:i + block_q], q_positions[..., i:i + block_q])
            for i in range(0, Sq, block_q)]
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return o.reshape(B, Sq, H, Dh)


def attention_block(
    x, p, cfg, *,
    positions,
    mask_kind: str,
    cache=None,          # {"k","v"}: (B, Smax, Hkv, Dh), or a paged pool
    #                      {"k_pool","v_pool"}: (P, bs, Hkv, Dh); written in place
    cache_len=None,      # int / 0-d tensor, OR a per-row (B,) int32 tensor
    pos_offset=None,     # (B,) left-padding per row (ragged prompts)
    block_table=None,    # (B, NB) int32 logical→physical block map (paged)
):
    """Self-attention sublayer: projections + RoPE + attention.

    Returns (out, cache).  ``p`` is an :class:`Attention` module.

    Ragged support: ``positions`` may be per-row (B, S) with negative values
    marking left-padding (masked out of the keys, clamped to 0 for RoPE),
    and ``cache_len`` may be a per-row vector — decode slots at different
    fill levels write their new KV at per-row offsets.  With a paged pool,
    the step scatters the new tokens' KV into their blocks; S == 1 causal
    attends through the paged decode kernel, S > 1 (a chunked-prefill
    chunk) over the gathered logical view.
    """
    B, S, D = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_

    q = (x @ p.wq).view(B, S, H, Dh)
    k = (x @ p.wk).view(B, S, Hkv, Dh)
    v = (x @ p.wv).view(B, S, Hkv, Dh)
    if cfg.attn_bias:
        q = q + p.bq.view(H, Dh)
        k = k + p.bk.view(Hkv, Dh)
        v = v + p.bv.view(Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)

    rope_pos = positions.clamp_min(0)    # pad slots: masked, not rotated
    q = rope(q, rope_pos, cfg.rope_theta)
    k = rope(k, rope_pos, cfg.rope_theta)
    if cache is None:
        k_pos, kv_len = positions, None
        k_full, v_full = k, v
    elif "k_pool" in cache:
        # Slot i's token t lands at logical position cache_len[i] + t =
        # physical (block_table[i, pos//bs], pos % bs).  Right-padded rows
        # of a chunked-prefill chunk route their junk positions to table
        # columns that point at scratch block 0; idle slots (cache_len 0,
        # all-scratch rows) write there too.  Nothing live reads block 0,
        # so the order of duplicate writes there does not matter.
        kp, vp = cache["k_pool"], cache["v_pool"]
        bs_blk = kp.shape[1]
        cl = torch.as_tensor(cache_len, dtype=torch.int32, device=x.device)
        if not cl.ndim:
            cl = cl.expand(B)
        tok_pos = cl[:, None].long() + torch.arange(S, device=x.device)
        rows = torch.arange(B, device=x.device)[:, None]
        phys = block_table.long()[rows, tok_pos // bs_blk]       # (B, S)
        off = tok_pos % bs_blk
        kp[phys, off] = k.to(kp.dtype)
        vp[phys, off] = v.to(vp.dtype)
        kv_len = cl + (S - 1)                                     # (B,) int32
        if S == 1 and mask_kind == "causal":
            o = paged_decode_attention(q[:, 0].contiguous(), kp, vp,
                                       block_table, kv_len.contiguous())
            return o.reshape(B, 1, H * Dh) @ p.wo, cache
        k_full = kp[block_table.long()].reshape(B, -1, Hkv, Dh)  # (B, NB·bs, ·)
        v_full = vp[block_table.long()].reshape(B, -1, Hkv, Dh)
        k_pos = torch.arange(k_full.shape[1], device=x.device)
    else:
        kc, vc = cache["k"], cache["v"]
        k_pos = torch.arange(kc.shape[1], device=x.device)
        if torch.is_tensor(cache_len) and cache_len.ndim:
            # per-row fill: each slot writes its single new token at its
            # own offset
            if S != 1:
                raise ValueError("per-row cache_len is a single-token decode path")
            rows = torch.arange(B, device=x.device)
            kc[rows, cache_len.long()] = k[:, 0].to(kc.dtype)
            vc[rows, cache_len.long()] = v[:, 0].to(vc.dtype)
        else:
            start = int(cache_len)
            kc[:, start:start + S] = k.to(kc.dtype)
            vc[:, start:start + S] = v.to(vc.dtype)
        kv_len = cache_len + S - 1
        if pos_offset is not None:
            # left-padded rows: cache slot j holds logical position
            # j - pad, pad slots (< 0) masked out by _mask_bias
            k_pos = k_pos[None, :] - pos_offset[:, None]
            kv_len = kv_len - pos_offset
        k_full, v_full = kc, vc

    o = blocked_attention(
        q, k_full, v_full,
        q_positions=positions, k_positions=k_pos,
        mask_kind=mask_kind, chunk=cfg.chunk_size, prefix=cfg.n_prefix,
        kv_len=kv_len,
    )
    # o is bf16 when V came from a bf16 cache; JAX promotes it to wo's dtype
    return o.reshape(B, S, H * Dh).to(p.wo.dtype) @ p.wo, cache


def mlp_block(x, p):
    h = F.silu(x @ p.gate) * (x @ p.up)
    return h @ p.down
