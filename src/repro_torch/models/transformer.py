"""Decoder-only LM assembly in PyTorch (port of ``repro/models/transformer.py``).

This slice ports the dense self-attention stack that the serving path
runs (qwen3-4b and the other ``family="dense"`` configs): ``layer_plan``,
the parameter shapes, ``init_params``, ``_run_stack``, ``_prefill_like``,
``prefill``, ``decode_step``, ``forward``, ``init_cache``,
``paged_cache_shapes`` and ``init_paged_cache``.  MoE, SSM, hybrid and
encoder-decoder plans, ``loss_fn`` and the abstract specs come with later
slices; ``layer_plan`` raises for them.

Parameters live in :class:`LM`: ``embed`` (V_padded, D), ``final_norm``,
one :class:`Block` per layer in ``blocks`` (an ``nn.ModuleList``) and,
for untied configs, ``lm_head`` (D, V_padded).  The reference stacks the
layers on a leading scan axis; the converter (``repro_torch.convert``)
unstacks them.  Caches keep the stacked layout
(``{"sub0": {"k": (n_layers, B, L, Hkv, Dh), ...}}``) and are written in
place; the functions still return them so call sites read like the
reference.

Entry points:
    forward(params, batch, cfg)              -- logits over all positions
    prefill(params, batch, cfg, max_len=)    -- last-token logits + dense cache
    decode_step(params, cache, batch, cfg)   -- step over a dense or paged cache
    init_params(cfg, seed, device=)          -- the reference's numpy draws
    init_cache / init_paged_cache(..., device=)
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import (
    MLP,
    Attention,
    _param,
    attention_block,
    mlp_block,
    rms_norm,
)

__all__ = [
    "Block",
    "LM",
    "layer_plan",
    "param_leaves",
    "param_of",
    "init_params",
    "forward",
    "prefill",
    "decode_step",
    "cache_shapes",
    "init_cache",
    "paged_cache_shapes",
    "init_paged_cache",
]

DTYPE = torch.bfloat16
_NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")
_ZEROS = ("bq", "bk", "bv")


# ---------------------------------------------------------------------------
# Layer plan and parameters
# ---------------------------------------------------------------------------


def layer_plan(cfg: ArchConfig) -> tuple[int, list[tuple[str, str]]]:
    """(n_layers, [(mixer, ffn)]) — the dense branch of the reference."""
    if (cfg.family in ("ssm", "hybrid") or cfg.hybrid_period or cfg.is_moe
            or cfg.n_encoder_layers or cfg.n_prefix):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) needs MoE/SSM/cross-attention/prefix "
            f"layers, which the port has not reached yet (ROADMAP.md, "
            f"Queue 1: 'MoE and SSD layers, cross-attention')")
    return cfg.n_layers, [("attn", "mlp")]


class Block(nn.Module):
    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype=dtype, device=device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
        self.mlp = MLP(cfg, dtype=dtype, device=device)


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype=DTYPE, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        n_layers, _ = layer_plan(cfg)
        V = cfg.padded_vocab()
        self.embed = _param((V, cfg.d_model), dtype, device)
        self.final_norm = _param((cfg.d_model,), dtype, device)
        self.blocks = nn.ModuleList(
            Block(cfg, dtype=dtype, device=device) for _ in range(n_layers))
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, V), dtype, device)


def _shape_tree(cfg: ArchConfig) -> dict:
    """The reference's parameter shape tree (stacked on the layer axis)."""
    n_layers, _ = layer_plan(cfg)
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    attn = {"wq": (D, H * Dh), "wk": (D, Hkv * Dh), "wv": (D, Hkv * Dh),
            "wo": (H * Dh, D)}
    if cfg.qk_norm:
        attn.update(q_norm=(Dh,), k_norm=(Dh,))
    if cfg.attn_bias:
        attn.update(bq=(H * Dh,), bk=(Hkv * Dh,), bv=(Hkv * Dh,))
    sub = {"ln1": (D,), "attn": attn, "ln2": (D,),
           "mlp": {"gate": (D, cfg.d_ff), "up": (D, cfg.d_ff),
                   "down": (cfg.d_ff, D)}}

    def stack(t):
        return ({k: stack(v) for k, v in t.items()} if isinstance(t, dict)
                else (n_layers, *t))

    tree = {"embed": (cfg.padded_vocab(), D), "final_norm": (D,),
            "blocks": {"sub0": stack(sub)}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (D, cfg.padded_vocab())
    return tree


def param_leaves(cfg: ArchConfig) -> list[tuple[tuple[str, ...], tuple]]:
    """(path, shape) of every parameter in the reference's leaf order:
    JAX flattens dicts by sorted key, so this is the order of its draws."""
    out = []

    def walk(path, t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(path + (k,), t[k])
        else:
            out.append((path, t))

    walk((), _shape_tree(cfg))
    return out


def param_of(model: LM, path: tuple[str, ...], layer: int | None = None):
    """The parameter at a reference path; ``blocks/sub0/...`` paths name
    the tensor of one ``layer``."""
    if path[0] == "blocks":
        obj = model.blocks[layer]
        for name in path[2:]:
            obj = getattr(obj, name)
        return obj
    return getattr(model, path[0])


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, *, device="cuda",
                dtype=DTYPE) -> LM:
    """The reference's numpy init, value for value: norms and biases zero,
    every matrix ``standard_normal(shape) / sqrt(shape[-2])`` drawn in the
    reference's leaf order and rounded to bf16.  Stacked leaves are drawn
    one layer slice at a time — ``standard_normal((L, a, b))`` equals L
    consecutive ``(a, b)`` draws — so host memory stays at one slice."""
    model = LM(cfg, dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    for path, shape in param_leaves(cfg):
        if path[-1] in _NORMS or path[-1] in _ZEROS:
            continue                    # zeros already, and no draw
        scale = 1.0 / math.sqrt(shape[-2])
        stacked = path[0] == "blocks"
        for layer in range(shape[0] if stacked else 1):
            draw = rng.standard_normal(shape[1:] if stacked else shape) * scale
            # round f64 → bf16 first, as the reference does, then to dtype
            value = torch.from_numpy(draw).to(torch.bfloat16).to(dtype)
            param_of(model, path, layer if stacked else None).copy_(value)
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _mask_kind(cfg: ArchConfig) -> str:
    if cfg.attention == "chunked":
        return "chunked"
    if cfg.n_prefix:
        return "prefix"
    return "causal"


def _layer_cache(cache, layer: int):
    return None if cache is None else {
        name: leaf[layer] for name, leaf in cache["sub0"].items()}


def _run_stack(blocks, x, cfg, *, positions, mask_kind, cache=None,
               cache_len=None, pos_offset=None, block_table=None):
    """Run the layers over x; cache leaves are written in place."""
    for layer, blk in enumerate(blocks):
        h = rms_norm(x, blk.ln1)
        mo, _ = attention_block(
            h, blk.attn, cfg, positions=positions, mask_kind=mask_kind,
            cache=_layer_cache(cache, layer), cache_len=cache_len,
            pos_offset=pos_offset, block_table=block_table)
        x = x + mo
        x = x + mlp_block(rms_norm(x, blk.ln2), blk.mlp)
    return x


def _prefill_like(cfg, params, batch, *, max_len, want_cache):
    """Embeddings → stack → final norm.  batch: tokens (B, S) int
    [+ pos_offset (B,)], where ``pos_offset`` marks per-row left-padding:
    positions become per-row and pad slots carry negatives."""
    layer_plan(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params.embed[tokens.long()]
    positions = torch.arange(S, device=x.device)
    pos_offset = batch.get("pos_offset")
    if pos_offset is not None:
        positions = positions[None, :] - pos_offset[:, None]     # (B, S)
    cache = init_cache(cfg, B, max_len, device=x.device) if want_cache else None
    x = _run_stack(params.blocks, x, cfg, positions=positions,
                   mask_kind=_mask_kind(cfg), cache=cache,
                   cache_len=0 if want_cache else None, pos_offset=pos_offset)
    return rms_norm(x, params.final_norm), cache


def _logits(cfg, params, x):
    head = params.embed.t() if cfg.tie_embeddings else params.lm_head
    return x @ head


@torch.no_grad()
def forward(params, batch, cfg: ArchConfig):
    """Training-mode forward → (logits over all positions, aux loss 0)."""
    x, _ = _prefill_like(cfg, params, batch, max_len=0, want_cache=False)
    return _logits(cfg, params, x), torch.zeros((), device=x.device)


@torch.no_grad()
def prefill(params, batch, cfg: ArchConfig, *, max_len: int | None = None):
    """Process the prompt; return {logits (B, 1, V), cache, cache_len}."""
    S = batch["tokens"].shape[1]
    max_len = max_len if max_len is not None else S
    x, cache = _prefill_like(cfg, params, batch, max_len=max_len,
                             want_cache=True)
    return {"logits": _logits(cfg, params, x[:, -1:]), "cache": cache,
            "cache_len": S}


@torch.no_grad()
def decode_step(params, cache, batch, cfg: ArchConfig):
    """One step over a cache → (logits (B, S, V), cache written in place).

    batch: tokens (B, S), cache_len (int, or a per-row (B,) int32 tensor)
    [, pos_offset (B,) for left-padded prompts, block_table (B, NB) int32
    when ``cache`` is a paged pool].  With a paged pool S may exceed 1:
    chunked prefill feeds prompt chunks through this path.
    """
    layer_plan(cfg)
    tokens, cache_len = batch["tokens"], batch["cache_len"]
    pos_offset = batch.get("pos_offset")
    B, S = tokens.shape
    x = params.embed[tokens.long()]
    steps = torch.arange(S, device=x.device)
    if (torch.is_tensor(cache_len) and cache_len.ndim) or pos_offset is not None:
        cl = torch.as_tensor(cache_len, device=x.device).expand(B)
        if pos_offset is not None:
            cl = cl - pos_offset
        positions = cl[:, None] + steps[None, :]                  # (B, S)
    else:
        positions = int(cache_len) + steps
    x = _run_stack(params.blocks, x, cfg, positions=positions,
                   mask_kind=_mask_kind(cfg), cache=cache, cache_len=cache_len,
                   pos_offset=pos_offset, block_table=batch.get("block_table"))
    x = rms_norm(x, params.final_norm)
    return _logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def cache_shapes(cfg: ArchConfig, B: int, max_len: int) -> dict:
    n_layers, _ = layer_plan(cfg)
    s = (n_layers, B, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"sub0": {"k": s, "v": s}}


def init_cache(cfg: ArchConfig, B: int, max_len: int, *, device="cuda",
               dtype=DTYPE) -> dict:
    """Zero dense KV cache, bf16 like the reference's."""
    device = resolve_device(device)
    return {sub: {name: torch.zeros(s, dtype=dtype, device=device)
                  for name, s in leaves.items()}
            for sub, leaves in cache_shapes(cfg, B, max_len).items()}


def paged_cache_shapes(cfg: ArchConfig, n_blocks: int, block_size: int) -> dict:
    """Shapes of the paged KV block pool: each layer stores K/V in
    ``n_blocks`` blocks of ``block_size`` tokens; a per-slot block table
    maps logical positions to physical blocks.  Physical block 0 is
    reserved as scratch for idle slots."""
    n_layers, _ = layer_plan(cfg)
    s = (n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim_)
    return {"sub0": {"k_pool": s, "v_pool": s}}


def init_paged_cache(cfg: ArchConfig, n_blocks: int, block_size: int, *,
                     device="cuda", dtype=DTYPE) -> dict:
    """Zero-filled block pool (see :func:`paged_cache_shapes`)."""
    device = resolve_device(device)
    return {sub: {name: torch.zeros(s, dtype=dtype, device=device)
                  for name, s in leaves.items()}
            for sub, leaves in paged_cache_shapes(cfg, n_blocks,
                                                  block_size).items()}
