"""Decoder-only LM assembly in PyTorch (port of ``repro/models/transformer.py``).

This slice ports the dense self-attention stack (qwen3-4b, internlm2-1.8b
and the other ``family="dense"`` configs) for serving and training:
``layer_plan``, the parameter shapes, ``init_params``, ``_run_stack``
(with remat), ``_prefill_like``, ``loss_fn``, ``forward``, ``prefill``,
``decode_step``, ``init_cache``, ``paged_cache_shapes``,
``init_paged_cache``, the abstract specs (``param_specs``,
``cache_specs``, ``input_specs``: tensors on the meta device, the
counterpart of JAX's ``ShapeDtypeStruct``) and ``warm_autotune`` for the
train, prefill and decode stages.  MoE, SSM, hybrid and encoder-decoder
plans come with a later slice; ``layer_plan`` raises for them.

Parameters live in :class:`LM`: ``embed`` (V_padded, D), ``final_norm``,
one :class:`Block` per layer in ``blocks`` (an ``nn.ModuleList``) and,
for untied configs, ``lm_head`` (D, V_padded).  The reference stacks the
layers on a leading scan axis; the converter (``repro_torch.convert``)
unstacks them.  Caches keep the stacked layout
(``{"sub0": {"k": (n_layers, B, L, Hkv, Dh), ...}}``) and are written in
place; the functions still return them so call sites read like the
reference.

Parameters are built with ``requires_grad=False``, so serving builds no
graph; a trainer turns them on for its own model
(``model.requires_grad_(True)``).  ``loss_fn`` and ``forward`` then carry
gradients, and with grad enabled each layer runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` per scanned
layer): the backward keeps one (B, S, D) input per layer and recomputes
the rest.  ``prefill`` and ``decode_step`` run under ``no_grad``.

Entry points:
    loss_fn(params, batch, cfg, seq_chunk=)  -- training loss, {"ce", "aux"}
    forward(params, batch, cfg)              -- logits over all positions
    prefill(params, batch, cfg, max_len=)    -- last-token logits + dense cache
    decode_step(params, cache, batch, cfg)   -- step over a dense or paged cache
    init_params(cfg, seed, device=)          -- the reference's numpy draws
    init_cache / init_paged_cache(..., device=)
    warm_autotune(cfg, batch_size=, seq_len=, stages=)
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    "loss_fn",
    "forward",
    "prefill",
    "decode_step",
    "cache_shapes",
    "init_cache",
    "paged_cache_shapes",
    "init_paged_cache",
    "param_specs",
    "cache_specs",
    "input_specs",
    "warm_autotune",
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


def _device(device) -> torch.device:
    """``resolve_device``, plus the meta device of the abstract specs."""
    if torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype=DTYPE, device="cuda"):
        super().__init__()
        device = _device(device)
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


def _block(x, blk, cfg, positions, mask_kind, cache, cache_len, pos_offset,
           block_table):
    """One layer: attention and MLP sublayers, each with its residual."""
    h = rms_norm(x, blk.ln1)
    mo, _ = attention_block(
        h, blk.attn, cfg, positions=positions, mask_kind=mask_kind,
        cache=cache, cache_len=cache_len, pos_offset=pos_offset,
        block_table=block_table)
    x = x + mo
    return x + mlp_block(rms_norm(x, blk.ln2), blk.mlp)


def _run_stack(blocks, x, cfg, *, positions, mask_kind, cache=None,
               cache_len=None, pos_offset=None, block_table=None):
    """Run the layers over x; cache leaves are written in place.  With
    grad enabled (training: no cache) each layer runs under a
    non-reentrant checkpoint, the reference's remat (the blocks draw no
    random numbers, so no RNG state is kept)."""
    remat = cache is None and torch.is_grad_enabled()
    for layer, blk in enumerate(blocks):
        args = (x, blk, cfg, positions, mask_kind, _layer_cache(cache, layer),
                cache_len, pos_offset, block_table)
        x = (checkpoint(_block, *args, use_reentrant=False,
                        preserve_rng_state=False) if remat else _block(*args))
    return x


def _prefill_like(cfg, params, batch, *, max_len, want_cache):
    """Embeddings → stack → final norm.  batch: tokens (B, S) int
    [+ pos_offset (B,)], where ``pos_offset`` marks per-row left-padding:
    positions become per-row and pad slots carry negatives.  Used by
    training (want_cache=False) and prefill (want_cache=True)."""
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


def forward(params, batch, cfg: ArchConfig):
    """Training-mode forward → (logits over all positions, aux loss 0)."""
    x, _ = _prefill_like(cfg, params, batch, max_len=0, want_cache=False)
    return _logits(cfg, params, x), torch.zeros((), device=x.device)


def _ce_sums(logits, targets):
    """(lse, lse - gold) of f32 ``logits`` (…, V) at int ``targets`` (…)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return lse, lse - gold


def _chunk_ce(xc, head, tc, vc):
    """Summed CE and z-loss of one sequence chunk; ``vc`` masks padding."""
    lse, ce = _ce_sums((xc @ head).float(), tc)
    return torch.sum(ce * vc), torch.sum(lse ** 2 * vc)


def loss_fn(params, batch, cfg: ArchConfig, *, z_loss: float = 1e-4,
            moe_aux: float = 1e-2, seq_chunk: int | None = None):
    """Next-token CE (f32 logsumexp over the padded vocab, pad columns
    included, as the reference) + z-loss + MoE load-balance aux (0 for
    the dense stack) → (loss, {"ce", "aux"}).

    ``seq_chunk``: logits and CE over sequence chunks of that many tokens
    (S − 1 padded up to whole chunks, the padding masked, sums divided by
    B·(S − 1)).  With grad enabled each chunk runs under a checkpoint, so
    neither pass holds more than one chunk's (B, seq_chunk, V) logits."""
    tokens = batch["tokens"]
    x, _ = _prefill_like(cfg, params, batch, max_len=0, want_cache=False)
    aux = torch.zeros((), device=x.device)
    if seq_chunk is None:
        lse, ce = _ce_sums(_logits(cfg, params, x)[:, :-1].float(), tokens[:, 1:])
        ce, zl = torch.mean(ce), torch.mean(lse ** 2)
        return ce + z_loss * zl + moe_aux * aux, {"ce": ce, "aux": aux}

    head = params.embed.t() if cfg.tie_embeddings else params.lm_head
    B, S, _ = x.shape
    n_tok = B * (S - 1)
    nc = -(-(S - 1) // seq_chunk)
    pad = nc * seq_chunk - (S - 1)
    # drop the final position (no next-token target), pad S-1 up to chunks
    xs = F.pad(x[:, :-1], (0, 0, 0, pad))
    tg = F.pad(tokens[:, 1:], (0, pad))
    valid = (torch.arange(nc * seq_chunk, device=x.device) < S - 1).float()
    ce_sum = zl_sum = 0.0
    for c in range(nc):
        part = slice(c * seq_chunk, (c + 1) * seq_chunk)
        args = (xs[:, part], head, tg[:, part], valid[part])
        ce_c, zl_c = (checkpoint(_chunk_ce, *args, use_reentrant=False,
                                 preserve_rng_state=False)
                      if torch.is_grad_enabled() else _chunk_ce(*args))
        ce_sum, zl_sum = ce_sum + ce_c, zl_sum + zl_c
    ce, zl = ce_sum / n_tok, zl_sum / n_tok
    return ce + z_loss * zl + moe_aux * aux, {"ce": ce, "aux": aux}


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
    device = _device(device)
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
    device = _device(device)
    return {sub: {name: torch.zeros(s, dtype=dtype, device=device)
                  for name, s in leaves.items()}
            for sub, leaves in paged_cache_shapes(cfg, n_blocks,
                                                  block_size).items()}


# ---------------------------------------------------------------------------
# Abstract specs and autotune warm-up
# ---------------------------------------------------------------------------

_META = torch.device("meta")


def param_specs(cfg: ArchConfig) -> LM:
    """The parameters as meta tensors: shapes and dtypes, no storage (the
    counterpart of the reference's ``ShapeDtypeStruct`` tree)."""
    return LM(cfg, device=_META)


def cache_specs(cfg: ArchConfig, B: int, max_len: int) -> dict:
    """The dense KV cache as meta tensors."""
    return init_cache(cfg, B, max_len, device=_META)


def input_specs(cfg: ArchConfig, kind: str, *, batch_size: int,
                seq_len: int) -> dict:
    """Meta stand-ins for the step inputs of one workload cell.

    train, prefill → {batch={tokens (B, S)}} (training reads its targets
    from the tokens);
    decode → {cache (dense, S long), batch={tokens (B, 1), cache_len}}.
    ``cache_len`` is the int 0: a meta tensor has no value to read, and
    no shape downstream depends on it."""
    B, S = batch_size, seq_len
    if kind in ("train", "prefill"):
        return {"batch": {"tokens": torch.empty((B, S), dtype=torch.int32,
                                                device=_META)}}
    if kind == "decode":
        return {"cache": cache_specs(cfg, B, S),
                "batch": {"tokens": torch.empty((B, 1), dtype=torch.int32,
                                                device=_META),
                          "cache_len": 0}}
    raise ValueError(f"no input specs for stage {kind!r}")


def warm_autotune(cfg: ArchConfig, *, batch_size: int, seq_len: int,
                  stages: tuple = ("train", "prefill", "decode")) -> dict:
    """Pre-populate the kernel tuning cache for one workload cell.

    Traces the requested entry points on the meta device (the reference
    uses ``jax.eval_shape``): no parameter is allocated or drawn, and
    every autotune lookup in ``models/layers.py`` fires with exactly the
    shapes a real run sees, so the process-default tuner searches (and, on
    a card, times) each missing config and persists the winner.  "train"
    (and, as in the reference, any stage but "prefill" and "decode")
    traces ``loss_fn``'s forward under ``no_grad``: the backward and the
    remat recompute look up the same shapes.  Returns the tuner's
    {hits, misses} delta."""
    from repro_torch.kernels.autotune import autotune_enabled, get_tuner

    if not autotune_enabled():
        return {"hits": 0, "misses": 0}
    tuner = get_tuner()
    h0, m0 = tuner.hits, tuner.misses
    params = param_specs(cfg)
    for stage in stages:
        kind = stage if stage in ("prefill", "decode") else "train"
        spec = input_specs(cfg, kind, batch_size=batch_size, seq_len=seq_len)
        if kind == "decode":
            decode_step(params, spec["cache"], spec["batch"], cfg)
        elif kind == "prefill":
            prefill(params, spec["batch"], cfg, max_len=seq_len)
        else:
            with torch.no_grad():
                loss_fn(params, spec["batch"], cfg)
    return {"hits": tuner.hits - h0, "misses": tuner.misses - m0}
