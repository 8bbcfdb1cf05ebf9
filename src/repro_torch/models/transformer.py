"""The unified LM in PyTorch (port of ``repro/models/transformer.py``):
dense, MoE, SSM, hybrid, VLM and encoder-decoder assembly.

One model covers the 10 registry architectures through the reference's
per-arch *layer plan*: the (mixer, ffn) sublayers one scan step runs.
Uniform archs step over ``n_layers`` identical blocks; jamba steps over
superblocks of 8 sublayers (7 SSD + 1 attention, dense and MoE FFNs in
turn); whisper adds a bidirectional encoder and cross-attention in the
decoder; paligemma prepends patch embeddings under a prefix mask.
``layer_plan``, the parameter shapes, ``init_params``, ``_run_stack``
(with remat), ``_prefill_like``, ``loss_fn``, ``forward``, ``prefill``,
``decode_step``, the caches (dense, with the f32 SSD state, and the
paged pool of a pure self-attention stack), the abstract specs
(``param_specs``, ``cache_specs``, ``input_specs``: tensors on the meta
device, the counterpart of JAX's ``ShapeDtypeStruct``) and
``warm_autotune`` are all ported.

Parameters live in :class:`LM`: ``embed`` (V_padded, D), ``final_norm``,
one scan step per entry of ``blocks`` (an ``nn.ModuleList``) and, for
untied configs, ``lm_head`` (D, V_padded); with an encoder, ``encoder``
(one :class:`Block` per layer) and ``enc_final_norm``.  A one-sublayer
plan keeps one :class:`Block` per step (``blocks.3.attn.wq``, the dense
names); a superblock is an ``nn.ModuleList`` of Blocks
(``blocks.0.5.ssm.w_x``), see :func:`param_name`.  The reference stacks
the steps on a leading scan axis; the converter (``repro_torch.convert``)
unstacks them.  Caches keep the stacked layout
(``{"sub0": {"k": (n_scan, B, L, Hkv, Dh), ...}}``) and are written in
place; the functions still return them so call sites read like the
reference.

Parameters are built with ``requires_grad=False``, so serving builds no
graph; a trainer turns them on for its own model
(``model.requires_grad_(True)``).  ``loss_fn`` and ``forward`` then carry
gradients, and with grad enabled each scan step runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
scan body: a jamba superblock is one checkpoint): the backward keeps one
(B, S, D) input per step and recomputes the rest.  ``prefill`` and
``decode_step`` run under ``no_grad``.

Entry points:
    loss_fn(params, batch, cfg, seq_chunk=)  -- training loss, {"ce", "aux"}
    forward(params, batch, cfg)              -- logits over text positions, aux
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
from repro_torch.models import layers as _L
from repro_torch.models.layers import (
    MLP,
    SSM,
    Attention,
    MoE,
    _maybe_constrain,
    _param,
    attention_block,
    mlp_block,
    moe_block,
    rms_norm,
    ssd_block,
    ssm_dims,
)

__all__ = [
    "Block",
    "LM",
    "layer_plan",
    "param_leaves",
    "param_name",
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
# leaves the reference's init sets to zeros (no draw), and to ones
_ZEROS = ("ln1", "ln2", "ln_cross", "final_norm", "enc_final_norm", "norm",
          "q_norm", "k_norm", "conv_b", "bq", "bk", "bv", "dt_bias")
_ONES = ("D",)
_ENC_PLAN = [("attn", "mlp")]


# ---------------------------------------------------------------------------
# Layer plans and parameters
# ---------------------------------------------------------------------------


def layer_plan(cfg: ArchConfig) -> tuple[int, list[tuple[str, str | None]]]:
    """(n_scan, [(mixer, ffn), ...] per scan step), as the reference's."""
    if cfg.family == "ssm":
        return cfg.n_layers, [("ssm", None)]
    if cfg.hybrid_period:
        if cfg.n_layers % cfg.hybrid_period:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                             f"multiple of hybrid_period {cfg.hybrid_period}")
        plan = []
        for i in range(cfg.hybrid_period):
            mixer = "attn" if i == cfg.hybrid_attn_index else "ssm"
            ffn = "moe" if (cfg.moe_every and i % cfg.moe_every == 1) else "mlp"
            plan.append((mixer, ffn))
        return cfg.n_layers // cfg.hybrid_period, plan
    mixer = "attn_cross" if cfg.n_encoder_layers else "attn"
    ffn = "moe" if cfg.is_moe else "mlp"
    return cfg.n_layers, [(mixer, ffn)]


class Block(nn.Module):
    """One (mixer, ffn) sublayer: ``ln1`` and ``attn`` (plus ``ln_cross``
    and ``cross`` for ``attn_cross``) or ``ssm``; then, unless ffn is
    None, ``ln2`` and ``mlp`` or ``moe``."""

    def __init__(self, cfg, mixer: str = "attn", ffn: str | None = "mlp", *,
                 dtype, device):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), dtype, device)
        if mixer.startswith("attn"):
            self.attn = Attention(cfg, dtype=dtype, device=device)
            if mixer == "attn_cross":
                self.cross = Attention(cfg, dtype=dtype, device=device)
                self.ln_cross = _param((cfg.d_model,), dtype, device)
        else:
            self.ssm = SSM(cfg, dtype=dtype, device=device)
        if ffn is not None:
            self.ln2 = _param((cfg.d_model,), dtype, device)
            module = MLP if ffn == "mlp" else MoE
            setattr(self, ffn, module(cfg, dtype=dtype, device=device))


def _scan_step(cfg, plan, *, dtype, device) -> nn.Module:
    """One scan step's parameters: a Block, or a superblock of Blocks."""
    blocks = [Block(cfg, m, f, dtype=dtype, device=device) for m, f in plan]
    return blocks[0] if len(blocks) == 1 else nn.ModuleList(blocks)


def _subs(step: nn.Module) -> list:
    return list(step) if isinstance(step, nn.ModuleList) else [step]


def _device(device) -> torch.device:
    """``resolve_device``, plus the meta device of the abstract specs."""
    if torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, dtype=DTYPE, device="cuda"):
        super().__init__()
        device = _device(device)
        n_scan, plan = layer_plan(cfg)
        self.cfg = cfg
        V = cfg.padded_vocab()
        self.embed = _param((V, cfg.d_model), dtype, device)
        self.final_norm = _param((cfg.d_model,), dtype, device)
        self.blocks = nn.ModuleList(
            _scan_step(cfg, plan, dtype=dtype, device=device)
            for _ in range(n_scan))
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, V), dtype, device)
        if cfg.n_encoder_layers:
            self.encoder = nn.ModuleList(
                Block(cfg, dtype=dtype, device=device)
                for _ in range(cfg.n_encoder_layers))
            self.enc_final_norm = _param((cfg.d_model,), dtype, device)


def _attn_shapes(cfg) -> dict:
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    s = {"wq": (D, H * Dh), "wk": (D, Hkv * Dh), "wv": (D, Hkv * Dh),
         "wo": (H * Dh, D)}
    if cfg.qk_norm:
        s.update(q_norm=(Dh,), k_norm=(Dh,))
    if cfg.attn_bias:
        s.update(bq=(H * Dh,), bk=(Hkv * Dh,), bv=(Hkv * Dh,))
    return s


def _mlp_shapes(cfg) -> dict:
    return {"gate": (cfg.d_model, cfg.d_ff), "up": (cfg.d_model, cfg.d_ff),
            "down": (cfg.d_ff, cfg.d_model)}


def _moe_shapes(cfg) -> dict:
    D, E, Ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff_
    return {"router": (D, E), "gate": (E, D, Ff), "up": (E, D, Ff),
            "down": (E, Ff, D)}


def _ssm_shapes(cfg) -> dict:
    D = cfg.d_model
    d_inner, H, _, N, d_conv_ch = ssm_dims(cfg)
    return {"w_z": (D, d_inner), "w_x": (D, d_inner), "w_B": (D, N),
            "w_C": (D, N), "w_dt": (D, H),
            "conv_w": (cfg.ssm_conv_width, d_conv_ch), "conv_b": (d_conv_ch,),
            "dt_bias": (H,), "A_log": (H,), "D": (H,), "norm": (d_inner,),
            "out_proj": (d_inner, D)}


def _block_shapes(cfg, plan) -> dict:
    out = {}
    for i, (mixer, ffn) in enumerate(plan):
        sub: dict = {"ln1": (cfg.d_model,)}
        if mixer.startswith("attn"):
            sub["attn"] = _attn_shapes(cfg)
            if mixer == "attn_cross":
                sub["cross"] = _attn_shapes(cfg)
                sub["ln_cross"] = (cfg.d_model,)
        else:
            sub["ssm"] = _ssm_shapes(cfg)
        if ffn is not None:
            sub["ln2"] = (cfg.d_model,)
            sub[ffn] = _mlp_shapes(cfg) if ffn == "mlp" else _moe_shapes(cfg)
        out[f"sub{i}"] = sub
    return out


def _stack(tree, n: int):
    return ({k: _stack(v, n) for k, v in tree.items()} if isinstance(tree, dict)
            else (n, *tree))


def _shape_tree(cfg: ArchConfig) -> dict:
    """The reference's parameter shape tree (stacked on the scan axis)."""
    n_scan, plan = layer_plan(cfg)
    V = cfg.padded_vocab()
    tree = {"embed": (V, cfg.d_model), "final_norm": (cfg.d_model,),
            "blocks": _stack(_block_shapes(cfg, plan), n_scan)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.d_model, V)
    if cfg.n_encoder_layers:
        tree["encoder"] = _stack(_block_shapes(cfg, _ENC_PLAN),
                                 cfg.n_encoder_layers)
        tree["enc_final_norm"] = (cfg.d_model,)
    return tree


def param_leaves(cfg: ArchConfig) -> list[tuple[tuple[str, ...], tuple]]:
    """(path, shape) of every parameter in the reference's leaf order:
    JAX flattens dicts by sorted key (capitals first), so this is the
    order of its draws."""
    out = []

    def walk(path, t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(path + (k,), t[k])
        else:
            out.append((path, t))

    walk((), _shape_tree(cfg))
    return out


def param_name(cfg: ArchConfig, path: tuple[str, ...],
               layer: int | None = None) -> str:
    """The port's parameter name of a reference path and scan step:
    ``("blocks", "sub0", "attn", "wq")`` at step 3 is ``blocks.3.attn.wq``,
    ``("blocks", "sub5", "ssm", "w_x")`` of a superblock plan
    ``blocks.3.5.ssm.w_x``, ``("encoder", "sub0", ...)`` ``encoder.3...``."""
    if path[0] not in ("blocks", "encoder"):
        return path[0]
    superblock = path[0] == "blocks" and len(layer_plan(cfg)[1]) > 1
    sub = (path[1].removeprefix("sub"),) if superblock else ()
    return ".".join((path[0], str(layer), *sub, *path[2:]))


def param_of(model: LM, path: tuple[str, ...], layer: int | None = None):
    """The parameter at a reference path; stacked paths (``blocks/...``,
    ``encoder/...``) name the tensor of one scan step ``layer``."""
    return model.get_parameter(param_name(model.cfg, path, layer))


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, *, device="cuda",
                dtype=DTYPE) -> LM:
    """The reference's numpy init, value for value: norms and biases zero,
    the SSD skip ``D`` ones, ``A_log = log(uniform(1, 16))`` and every
    matrix ``standard_normal(shape) / sqrt(shape[-2])``, drawn in the
    reference's leaf order and rounded to bf16.  Stacked leaves are drawn
    one scan step at a time — ``standard_normal((L, a, b))`` equals L
    consecutive ``(a, b)`` draws, and so does ``uniform`` — so host memory
    stays at one slice of each shape, drawn into and scaled in place: the
    same values as a fresh array a draw, without a fresh allocation (whose
    page faults cost a third of a full-width draw's host time)."""
    model = LM(cfg, dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    buffers: dict[tuple, np.ndarray] = {}
    for path, shape in param_leaves(cfg):
        name = path[-1]
        if name in _ZEROS:
            continue                    # zeros already, and no draw
        stacked = path[0] in ("blocks", "encoder")
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        for layer in range(shape[0] if stacked else 1):
            target = param_of(model, path, layer if stacked else None)
            if name in _ONES:
                target.fill_(1.0)
                continue
            size = tuple(shape[1:] if stacked else shape)
            if name == "A_log":
                draw = np.log(rng.uniform(1.0, 16.0, size))
            else:
                draw = buffers.setdefault(size, np.empty(size))
                rng.standard_normal(size, out=draw)
                draw *= 1.0 / math.sqrt(fan_in)
            # round f64 → bf16 first, as the reference does, then to dtype
            target.copy_(torch.from_numpy(draw).to(torch.bfloat16).to(dtype))
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


def _step_caches(cache, layer: int, n_subs: int) -> list:
    """Each sublayer's cache leaves at one scan step (views, written in
    place), or Nones."""
    if cache is None:
        return [None] * n_subs
    return [{name: leaf[layer] for name, leaf in cache[f"sub{i}"].items()}
            for i in range(n_subs)]


def _seq(h):
    """``h`` (B, S, D) with its sequence whole: batch on DP, the rest
    replicated (the identity without a hint mesh)."""
    return _maybe_constrain(h, "dp", None, None)


def _block(x, aux, step, cfg, plan, positions, mask_kind, memory, caches,
          cache_len, pos_offset, block_table, ssm_valid):
    """One scan step: every (mixer, ffn) sublayer of the plan, each with
    its residual; MoE aux losses are added to ``aux``.  Under a hint mesh
    each sublayer's normed input is gathered over the sequence (``_seq``:
    the all-gather that opens a sequence-parallel sublayer)."""
    for (mixer, ffn), blk, sc in zip(plan, _subs(step), caches):
        h = _seq(rms_norm(x, blk.ln1))
        if mixer.startswith("attn"):
            mo, _ = attention_block(
                h, blk.attn, cfg, positions=positions, mask_kind=mask_kind,
                cache=sc, cache_len=cache_len, pos_offset=pos_offset,
                block_table=block_table)
            x = x + mo
            if mixer == "attn_cross":
                co, _ = attention_block(
                    _seq(rms_norm(x, blk.ln_cross)), blk.cross, cfg,
                    positions=positions, mask_kind="full", kv_source=memory)
                x = x + co
        else:
            mo, _ = ssd_block(h, blk.ssm, cfg, cache=sc, valid=ssm_valid)
            x = x + mo
        if ffn == "mlp":
            x = x + mlp_block(_seq(rms_norm(x, blk.ln2)), blk.mlp)
        elif ffn == "moe":
            fo, a = moe_block(_seq(rms_norm(x, blk.ln2)), blk.moe, cfg)
            x = x + fo
            aux = aux + a
    return x, aux


def _run_stack(blocks, x, cfg, plan, *, positions, mask_kind, memory=None,
               cache=None, cache_len=None, pos_offset=None, block_table=None):
    """Run the scan steps over x → (x, aux); cache leaves are written in
    place.  ``pos_offset`` (B,) marks left-padding per row: attention masks
    the pad slots, SSD mixers treat them as zero-input unit-decay steps.
    With grad enabled (training: no cache) each step runs under a
    non-reentrant checkpoint, the reference's remat (the blocks draw no
    random numbers, so no RNG state is kept)."""
    ssm_valid = positions >= 0 if positions.ndim == 2 else None
    remat = cache is None and torch.is_grad_enabled()
    aux = torch.zeros((), device=x.device)
    for layer, step in enumerate(blocks):
        args = (x, aux, step, cfg, plan, positions, mask_kind, memory,
                _step_caches(cache, layer, len(plan)), cache_len, pos_offset,
                block_table, ssm_valid)
        x, aux = (checkpoint(_block, *args, use_reentrant=False,
                             preserve_rng_state=False) if remat else _block(*args))
        # Sequence parallelism (the reference's perf iteration B2): the
        # carry — the remat-saved residual stream — sharded over the model
        # axis on its sequence dim.  The identity without a hint mesh or
        # when S doesn't divide (decode S=1).
        if _L.SP_HINT:
            x = _maybe_constrain(x, "dp", "model", None)
    return x, aux


def _prefill_like(cfg, params, batch, *, max_len, want_cache):
    """Embeddings → (encoder) → stack → final norm → (x, aux, cache,
    memory).  batch: tokens (B, S) int [+ patches (B, n_prefix, D) |
    frames (B, F, D) | pos_offset (B,)], where ``pos_offset`` marks per-row
    left-padding: positions become per-row and pad slots carry negatives.
    Used by training (want_cache=False) and prefill (want_cache=True)."""
    _, plan = layer_plan(cfg)
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = _embed(params.embed, tokens)
    if cfg.n_prefix:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    pos_offset = batch.get("pos_offset")
    if pos_offset is not None:
        if cfg.n_prefix or cfg.n_encoder_layers:
            raise ValueError("ragged (left-padded) prompts need a plain "
                             "self-attention stack")
        positions = positions[None, :] - pos_offset[:, None]     # (B, S)

    memory = None
    if cfg.n_encoder_layers:
        frames = batch["frames"].to(x.dtype)
        memory, _ = _run_stack(
            params.encoder, frames, cfg, _ENC_PLAN,
            positions=torch.arange(frames.shape[1], device=x.device),
            mask_kind="full")
        memory = rms_norm(memory, params.enc_final_norm)

    cache = (init_cache(cfg, B, max_len, device=x.device, conv_dtype=x.dtype)
             if want_cache else None)
    if cache is not None and _L._is_dtensor(x):
        cache = _place_cache(cfg, cache, B, max_len)
    x, aux = _run_stack(params.blocks, x, cfg, plan, positions=positions,
                        mask_kind=_mask_kind(cfg), memory=memory, cache=cache,
                        cache_len=0 if want_cache else None,
                        pos_offset=pos_offset)
    return _seq(rms_norm(x, params.final_norm)), aux, cache, memory


def _embed(table, tokens):
    """The embedding rows of ``tokens``: an index into the table, or, on a
    DTensor table, the vocab-parallel lookup on each rank's shard
    (:func:`_vocab_parallel_embed`) under a hint mesh."""
    if _L._is_dtensor(table):
        return _vocab_parallel_embed(table, tokens)
    return table[tokens.long()]


def _vocab_parallel_embed(table, tokens):
    """Megatron's vocab-parallel embedding, written out: each rank looks up
    the tokens its rows of the table hold (the others read a zero row),
    the ranks' results summed over the vocab's mesh dims and scattered over
    the hidden dim (a reduce-scatter); rows over the data-parallel axes as
    the batch.  Exact: every token is
    one rank's row plus zeros.  (DTensor's own rules for the index or for
    ``F.embedding`` fail in one release or another on its backward or its
    reduction.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import placements

    mesh = table.device_mesh
    vocab = [i for i, pl in enumerate(table.placements) if pl == Shard(0)]
    table = table.redistribute(mesh, [Shard(0) if i in vocab else Replicate()
                                      for i in range(mesh.ndim)])
    rows = _L._hint_spec(tokens.shape[:1], ("dp",))
    tok_pl = list(placements(mesh, rows))
    tok = (tokens.redistribute(mesh, tok_pl) if _L._is_dtensor(tokens)
           else DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False).redistribute(mesh, tok_pl))
    local_tok = tok.to_local().long()
    # the table's gradient on this rank holds only its own rows' tokens:
    # a partial sum over the mesh dims the batch is split on
    local = table.to_local(grad_placements=[
        Shard(0) if i in vocab else Partial() if isinstance(tok_pl[i], Shard)
        else Replicate() for i in range(mesh.ndim)])
    if vocab:
        n = local.shape[0]
        lo = 0
        for i in vocab:                      # the shard's first row
            lo = lo * mesh.size(i) + mesh.get_local_rank(i)
        lo *= n
        held = (local_tok >= lo) & (local_tok < lo + n)
        out = torch.where(held[..., None], local[(local_tok - lo).clamp(0, n - 1)], 0)
    else:
        out = local[local_tok]
    pl = [Partial() if i in vocab else tok_pl[i] for i in range(mesh.ndim)]
    # reduced over the vocab's dims at once, scattered over the hidden dim
    # where it divides (a reduce-scatter): a Partial residual stream would
    # carry the reduction into every later op
    d = table.shape[1]
    out_pl = [(Shard(2) if d % mesh.size(i) == 0 else Replicate()) if i in vocab
              else tok_pl[i] for i in range(mesh.ndim)]
    return DTensor.from_local(out, mesh, pl, run_check=False).redistribute(mesh, out_pl)


def _place_cache(cfg, cache, B: int, max_len: int) -> dict:
    """The prefill cache of a sharded forward placed on the hint mesh by
    the reference's ``cache_pspecs`` (its prefill's ``out_shardings``)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding as sh

    mesh = _L._HINT_MESH
    spec = sh.cache_pspecs(cfg, ShapeSpec("cache", max_len, B, "prefill"), mesh)
    return sh.distribute_tree(cache, sh.to_named(mesh, spec))


def _logits(cfg, params, x):
    head = params.embed.t() if cfg.tie_embeddings else params.lm_head
    return x @ head


def _text(cfg, x):
    """Drop the prefix (patch) positions: logits cover text tokens only."""
    return x[:, cfg.n_prefix:] if cfg.n_prefix else x


def forward(params, batch, cfg: ArchConfig):
    """Training-mode forward → (logits over text positions, aux loss)."""
    x, aux, _, _ = _prefill_like(cfg, params, batch, max_len=0, want_cache=False)
    return _logits(cfg, params, _text(cfg, x)), aux


def _ce_sums(logits, targets):
    """(lse, lse - gold) of f32 ``logits`` (…, V) at int ``targets`` (…)."""
    lse = torch.logsumexp(logits, dim=-1)
    # the gold logit keeps its last dim until the subtraction: on logits
    # sharded over the vocab it is a masked partial sum, reduced there
    gold = torch.gather(logits, -1, targets.long()[..., None])
    return lse, (lse[..., None] - gold)[..., 0]


def _chunk_ce(xc, head, tc, vc):
    """Summed CE and z-loss of one sequence chunk; ``vc`` masks padding."""
    lse, ce = _ce_sums((xc @ head).float(), tc)
    return torch.sum(ce * vc), torch.sum(lse ** 2 * vc)


def loss_fn(params, batch, cfg: ArchConfig, *, z_loss: float = 1e-4,
            moe_aux: float = 1e-2, seq_chunk: int | None = None):
    """Next-token CE over the text positions (f32 logsumexp over the
    padded vocab, pad columns included, as the reference) + z-loss + the
    MoE load-balance aux summed over the MoE sublayers (0 without one) →
    (loss, {"ce", "aux"}).

    ``seq_chunk``: logits and CE over sequence chunks of that many tokens
    (S − 1 padded up to whole chunks, the padding masked, sums divided by
    B·(S − 1)).  With grad enabled each chunk runs under a checkpoint, so
    neither pass holds more than one chunk's (B, seq_chunk, V) logits."""
    tokens = batch["tokens"]
    x, aux, _, _ = _prefill_like(cfg, params, batch, max_len=0, want_cache=False)
    x = _text(cfg, x)
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
    """Process the prompt (and the prefix or the encoder's frames); return
    {logits (B, 1, V), cache, cache_len = S + n_prefix[, memory]}."""
    S = batch["tokens"].shape[1] + cfg.n_prefix
    max_len = max_len if max_len is not None else S
    x, _, cache, memory = _prefill_like(cfg, params, batch, max_len=max_len,
                                        want_cache=True)
    out = {"logits": _logits(cfg, params, x[:, -1:]), "cache": cache,
           "cache_len": S}
    if memory is not None:
        out["memory"] = memory
    return out


@torch.no_grad()
def decode_step(params, cache, batch, cfg: ArchConfig):
    """One step over a cache → (logits (B, S, V), cache written in place).

    batch: tokens (B, S), cache_len (int, or a per-row (B,) int32 tensor)
    [, memory (B, Sm, D) for cross-attention, pos_offset (B,) for
    left-padded prompts, block_table (B, NB) int32 when ``cache`` is a
    paged pool].  With a paged pool S may exceed 1: chunked prefill feeds
    prompt chunks through this path.
    """
    _, plan = layer_plan(cfg)
    tokens, cache_len = batch["tokens"], batch["cache_len"]
    pos_offset = batch.get("pos_offset")
    B, S = tokens.shape
    x = _embed(params.embed, tokens)
    steps = torch.arange(S, device=x.device)
    if (torch.is_tensor(cache_len) and cache_len.ndim) or pos_offset is not None:
        cl = torch.as_tensor(cache_len, device=x.device).expand(B)
        if pos_offset is not None:
            cl = cl - pos_offset
        positions = cl[:, None] + steps[None, :]                  # (B, S)
    else:
        positions = int(cache_len) + steps
    x, _ = _run_stack(params.blocks, x, cfg, plan, positions=positions,
                      mask_kind=_mask_kind(cfg), memory=batch.get("memory"),
                      cache=cache, cache_len=cache_len, pos_offset=pos_offset,
                      block_table=batch.get("block_table"))
    x = rms_norm(x, params.final_norm)
    return _logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _sub_cache_shape(cfg, mixer, B, max_len) -> dict:
    if mixer.startswith("attn"):
        Hkv, Dh = cfg.n_kv_heads, cfg.head_dim_
        return {"k": (B, max_len, Hkv, Dh), "v": (B, max_len, Hkv, Dh)}
    _, H, P, N, d_conv_ch = ssm_dims(cfg)
    return {"conv": (B, cfg.ssm_conv_width - 1, d_conv_ch),
            "state": (B, H, P, N)}


def cache_shapes(cfg: ArchConfig, B: int, max_len: int) -> dict:
    n_scan, plan = layer_plan(cfg)
    return {f"sub{i}": {k: (n_scan, *s) for k, s in
                        _sub_cache_shape(cfg, mixer, B, max_len).items()}
            for i, (mixer, _) in enumerate(plan)}


def init_cache(cfg: ArchConfig, B: int, max_len: int, *, device="cuda",
               dtype=DTYPE, conv_dtype=None) -> dict:
    """Zero dense cache: K/V (and the SSD conv taps) bf16 like the
    reference's, the SSD ``state`` f32.  ``conv_dtype`` (default
    ``dtype``): ``prefill`` keeps the conv taps in the activations' dtype,
    as the reference's scan returns them."""
    device = _device(device)
    kinds = {"state": torch.float32, "conv": conv_dtype or dtype}
    return {sub: {name: torch.zeros(s, dtype=kinds.get(name, dtype),
                                    device=device)
                  for name, s in leaves.items()}
            for sub, leaves in cache_shapes(cfg, B, max_len).items()}


def paged_cache_shapes(cfg: ArchConfig, n_blocks: int, block_size: int) -> dict:
    """Shapes of the paged KV block pool: each self-attention sublayer
    stores K/V in ``n_blocks`` blocks of ``block_size`` tokens; a per-slot
    block table maps logical positions to physical blocks.  Physical block
    0 is reserved as scratch for idle slots.  A plan with any other mixer
    raises, as the reference's does."""
    n_scan, plan = layer_plan(cfg)
    out = {}
    for i, (mixer, _) in enumerate(plan):
        if mixer != "attn":
            raise ValueError(
                f"paged KV cache needs a pure self-attention stack; "
                f"{cfg.name} has a {mixer!r} mixer (use the dense cache)")
        s = (n_scan, n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim_)
        out[f"sub{i}"] = {"k_pool": s, "v_pool": s}
    return out


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
    """The dense cache as meta tensors."""
    return init_cache(cfg, B, max_len, device=_META)


def input_specs(cfg: ArchConfig, kind: str, *, batch_size: int,
                seq_len: int) -> dict:
    """Meta stand-ins for the step inputs of one workload cell.

    train, prefill → {batch={tokens (B, S) [, patches | frames]}}
    (training reads its targets from the tokens);
    decode → {cache (dense, S long), batch={tokens (B, 1), cache_len
    [, memory]}}.  ``cache_len`` is the int 0: a meta tensor has no value
    to read, and no shape downstream depends on it."""
    B, S = batch_size, seq_len

    def spec(*shape, dtype=DTYPE):
        return torch.empty(shape, dtype=dtype, device=_META)

    if kind in ("train", "prefill"):
        batch = {"tokens": spec(B, S, dtype=torch.int32)}
        if cfg.n_prefix:
            batch["patches"] = spec(B, cfg.n_prefix, cfg.d_model)
        if cfg.n_encoder_layers:
            batch["frames"] = spec(B, cfg.n_audio_frames, cfg.d_model)
        return {"batch": batch}
    if kind == "decode":
        batch = {"tokens": spec(B, 1, dtype=torch.int32), "cache_len": 0}
        if cfg.n_encoder_layers:
            batch["memory"] = spec(B, cfg.n_audio_frames, cfg.d_model)
        return {"cache": cache_specs(cfg, B, S), "batch": batch}
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
