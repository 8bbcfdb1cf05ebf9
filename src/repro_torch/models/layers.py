"""Transformer building blocks in PyTorch (port of ``repro/models/layers.py``).

Everything the reference's layer plans use: ``rms_norm``, ``rope``,
``_mask_bias``, ``blocked_attention``, ``attention_block`` (self-attention
with no cache, a dense cache or a paged pool, and cross-attention over a
memory), ``mlp_block``, the capacity-dispatch ``moe_block`` (with
``moe_capacity``, the dispatch and combine of its token groups and
``_load_balance_loss``) and the Mamba-2 mixer ``ssd_block`` over the
chunked scan ``ssd_scan`` (with ``_segsum``, also the oracle of the SSD
kernel); plus the parameter modules ``Attention``, ``MLP``, ``MoE`` and
``SSM``.

``blocked_attention``'s query block comes from the kernel autotuner when
the caller passes none (``_tuned_attention_block_q``): it shares the
flash-attention tiling model and cache, as in the reference.  So do the
MoE dispatch's (groups, capacity factor) (``_tuned_moe_dispatch``, the
``moe_dispatch`` tiling model) and the SSD chunk (``_tuned_ssm_chunk``,
the ``ssm_scan`` tiling model, whose runner times the SSD kernel on the
card).  ``ssd_block`` itself runs the plain ``ssd_scan``, as the
reference's runs its own (``layers.py:662``), so the SSD kernel is
reached only through the tuner.

Sharding hints: :func:`hint_mesh` installs a ``DeviceMesh`` for the call
of a sharded step (``launch.lowering.sharded``, which the trainer, the
dry-run and the campaign run; serving leaves it unset),
:func:`sequence_parallel` says whether the residual stream's hint runs,
and :func:`_maybe_constrain` redistributes a ``DTensor``
activation to the reference's spec on it — the reference's
``with_sharding_constraint``, with its divisibility rule.  It is the
identity on a plain tensor or with no mesh set.  The MoE block carries
the reference's four hints (the ``(G, E, C, ·)`` buffer over
``("dp", "model")``, where the all-to-all comes from); the residual
stream's sequence-parallel hint is in ``transformer._run_stack``.

Parameters keep the JAX layout: ``(in, out)`` weights used as ``x @ W``.
They are built with ``requires_grad=False`` (serving builds no graph); a
trainer turns them on for its own model.  Every function here is then
differentiable on the no-cache path: nothing writes in place into a
tensor that autograd saved.  Caches are updated in place (``index_put_``
/ slice assignment) where the JAX package returns a new buffer that the
jit donates — only the serving path, under ``no_grad``, writes them;
``attention_block`` still returns ``(out, cache)`` with the same cache
object.

A decode step (S == 1, causal) over the paged pool always goes through
:func:`repro_torch.kernels.paged_decode.paged_decode_attention`: the CUDA
kernel for tensors on the card, its plain version for CPU tensors.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.paged_decode import paged_decode_attention
from repro_torch.launch.mesh import is_dtensor

__all__ = [
    "hint_mesh",
    "sequence_parallel",
    "Attention",
    "MLP",
    "MoE",
    "SSM",
    "rms_norm",
    "rope",
    "blocked_attention",
    "attention_block",
    "mlp_block",
    "moe_block",
    "moe_capacity",
    "ssd_block",
    "ssd_scan",
    "ssm_dims",
]

_NEG_INF = -1e30

_HINT_MESH = None  # installed by hint_mesh for the call of a sharded step
SP_HINT = True     # sequence-parallel residual stream (the reference's
#                    perf iteration B2; off with the dry-run's --no-sp)


@contextlib.contextmanager
def hint_mesh(mesh, *, sp: bool = True):
    """Install the ``DeviceMesh`` used for activation sharding hints inside
    model code for the block (``launch.lowering.sharded`` enters it around
    each call of a sharded step), with the sequence-parallel hint ``sp``;
    the previous mesh is restored on exit.  With no mesh installed every
    hint is the identity."""
    global _HINT_MESH, SP_HINT
    prev = _HINT_MESH, SP_HINT
    _HINT_MESH, SP_HINT = mesh, sp
    try:
        yield
    finally:
        _HINT_MESH, SP_HINT = prev


def sequence_parallel(mesh, sp: bool = True) -> bool:
    """The sequence-parallel hint a step over ``mesh`` runs with: ``sp``,
    turned off — and said so on stdout — where this torch's DTensor cannot
    view a tensor sharded on its sequence dim (:func:`seq_shard_views`)."""
    if sp and not seq_shard_views(mesh):
        dims = "x".join(str(n) for n in mesh.mesh.shape)
        print(f"sequence-parallel hint off on the {dims} mesh "
              f"{tuple(mesh.mesh_dim_names)}: this torch's DTensor cannot view a "
              "sequence-sharded activation", flush=True)
        return False
    return sp


def seq_shard_views(mesh) -> bool:
    """Whether this torch's DTensor flattens (B, S, ·) into (B·S, ·) with S
    sharded, as every product over the sequence-parallel residual stream
    does (DTensor records it as a strided shard; releases that cannot
    raise).  Probed once per mesh on meta tensors."""
    key = (tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape), mesh.device_type)
    if key not in _SEQ_VIEWS:
        from torch.distributed.tensor import DTensor, Replicate, Shard

        sizes = tuple(mesh.mesh.shape)
        if max(sizes) == 1:
            _SEQ_VIEWS[key] = True
        else:
            dim = sizes.index(max(sizes))
            pl = [Replicate()] * len(sizes)
            pl[dim] = Shard(1)
            n = sizes[dim]
            x = DTensor.from_local(torch.empty(2, 2, 4, device="meta"), mesh, pl,
                                   run_check=False, shape=(2, 2 * n, 4),
                                   stride=(8 * n, 4, 1))
            try:
                x.reshape(-1, 4)
                _SEQ_VIEWS[key] = True
            except RuntimeError:
                _SEQ_VIEWS[key] = False
    return _SEQ_VIEWS[key]


_SEQ_VIEWS: dict = {}


def _hint_spec(shape, spec_dims) -> tuple:
    """The reference's spec dims resolved on the hint mesh: "dp" to the
    data-parallel axes present, an axis name kept, each only where it
    divides the dim; else None."""
    mesh = _HINT_MESH
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, tuple(mesh.mesh.shape)))
    dims = []
    for i, d in enumerate(spec_dims):
        if d == "dp":
            dp = tuple(a for a in ("pod", "data") if a in names)
            n = 1
            for a in dp:
                n *= sizes[a]
            dims.append((dp if len(dp) > 1 else dp[0])
                        if dp and shape[i] % n == 0 else None)
        elif d is not None and d in names and shape[i] % sizes[d] == 0:
            dims.append(d)
        else:
            dims.append(None)
    return tuple(dims)


def _is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` of a sharded step (a hint mesh is
    installed)."""
    return _HINT_MESH is not None and is_dtensor(x)


def _maybe_constrain(x, *spec_dims):
    """Redistribute the DTensor ``x`` to ``spec_dims`` on the hint mesh, or
    return ``x`` when no mesh is set or ``x`` is a plain tensor.

    spec dims may be None, an axis name, or the special "dp" marker resolved
    to the data-parallel axes present on the mesh (("pod","data")/("data",)).
    Divisibility is checked per dim; non-divisible dims fall back to None.
    """
    if not _is_dtensor(x):
        return x
    from repro_torch.distributed.sharding import placements

    mesh = _HINT_MESH
    return x.redistribute(mesh, placements(mesh, _hint_spec(x.shape, spec_dims)))


def _constrain_spec(x, spec):
    """``x`` redistributed to an already resolved spec on the hint mesh."""
    from repro_torch.distributed.sharding import placements

    return x.redistribute(_HINT_MESH, placements(_HINT_MESH, spec))


def _on_shards(fn, args, specs, out_spec):
    """``fn`` on each rank's local shards, for code that DTensor has no
    sharding rule for (the dispatch's ``gather``/``searchsorted``/
    ``scatter``) or whose reshapes it cannot follow (attention's GQA
    split of the heads).  Each DTensor argument (or tuple of them) is
    redistributed to its resolved spec in ``specs`` (missing trailing
    dims replicated), ``fn`` runs on the local tensors, and every tensor
    it returns is wrapped back with ``out_spec`` (a list: one spec for
    each result of a tuple).  Plain arguments pass
    as they are; with none a DTensor, ``fn(*args)``."""
    if not any(_is_dtensor(a) or (isinstance(a, tuple) and any(map(_is_dtensor, a)))
               for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import placements

    mesh = _HINT_MESH

    def local(a, spec):
        if isinstance(a, tuple):
            return tuple(local(u, spec) for u in a)
        if not isinstance(a, DTensor):
            return a
        t = a.redistribute(mesh, placements(mesh, spec)).to_local()
        return t.wait() if hasattr(t, "wait") else t    # an async collective

    def wrap(t, spec):
        if isinstance(spec, list):          # one spec per result
            return tuple(wrap(u, sp) for u, sp in zip(t, spec))
        if isinstance(t, tuple):
            return tuple(wrap(u, spec) for u in t)
        return DTensor.from_local(t, mesh, placements(mesh, spec), run_check=False)

    return wrap(fn(*(local(a, sp) for a, sp in zip(args, specs))), out_spec)


def _groups_spec(n: int) -> tuple:
    """The resolved spec of a leading dim of ``n`` groups (or rows) over
    the data-parallel axes."""
    return _hint_spec((n,), ("dp",))


def _per_group(fn, *args):
    """``fn`` over each rank's token groups: the reference ``vmap``s it
    over groups laid out on DP; the leading (group) dim of every DTensor
    argument and result over the data-parallel axes, the rest replicated."""
    lead = next((a for a in args if _is_dtensor(a)), None)
    if lead is None:
        return fn(*args)
    spec = _groups_spec(lead.shape[0])
    return _on_shards(fn, args, [spec] * len(args), spec)


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


class MoE(nn.Module):
    """router (D, E), gate/up (E, D, F), down (E, F, D)."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        D, E, Ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff_
        self.router = _param((D, E), dtype, device)
        self.gate = _param((E, D, Ff), dtype, device)
        self.up = _param((E, D, Ff), dtype, device)
        self.down = _param((E, Ff, D), dtype, device)


def ssm_dims(cfg) -> tuple[int, int, int, int, int]:
    """(d_inner, H, P, N, d_conv_ch) of the SSD mixer (one B/C group)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    return d_inner, d_inner // P, P, N, d_inner + 2 * N


class SSM(nn.Module):
    """The Mamba-2 mixer, one projection per segment (ref
    ``transformer.py:115-136``): w_z, w_x (D, d_inner), w_B, w_C (D, N),
    w_dt (D, H), conv_w (W, d_conv_ch), conv_b (d_conv_ch,), dt_bias,
    A_log, D (H,), norm (d_inner,), out_proj (d_inner, D)."""

    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        Dm = cfg.d_model
        d_inner, H, _, N, d_conv_ch = ssm_dims(cfg)
        self.w_z = _param((Dm, d_inner), dtype, device)
        self.w_x = _param((Dm, d_inner), dtype, device)
        self.w_B = _param((Dm, N), dtype, device)
        self.w_C = _param((Dm, N), dtype, device)
        self.w_dt = _param((Dm, H), dtype, device)
        self.conv_w = _param((cfg.ssm_conv_width, d_conv_ch), dtype, device)
        self.conv_b = _param((d_conv_ch,), dtype, device)
        self.dt_bias = _param((H,), dtype, device)
        self.A_log = _param((H,), dtype, device)
        self.D = _param((H,), dtype, device)
        self.norm = _param((d_inner,), dtype, device)
        self.out_proj = _param((d_inner, Dm), dtype, device)


def _tuned_attention_block_q(q, k, causal: bool) -> int:
    """Query-block size for :func:`blocked_attention`, from the autotuner.

    Shares the flash-attention tiling model (and its device-keyed cache)
    with the kernel, as the reference does (``layers.py:87-103``); falls
    back to the tiling default, the largest divisor of Sq ≤ 512."""
    from repro_torch.kernels.autotune import tuned_config
    from repro_torch.kernels.flash_attention import tiling

    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    shape = tiling.shape_key((B, H, Sq, Dh), (B, Hkv, k.shape[1], Dh),
                             causal=causal, dtype=q.dtype)
    return int(tuned_config("flash_attention", shape,
                            tiling.default(shape)).get("block_q", 512))


def _tuned_moe_dispatch(B: int, S: int, cfg, dtype) -> tuple[int, float]:
    """(groups, capacity_factor) for :func:`moe_block`, from the autotuner
    (the ``moe_dispatch`` tiling model, which has no runner: every spec
    ranks it by its cost model), as the reference's (``layers.py:106-137``).

    Falls back to ``gcd(B, moe_groups or 32)`` groups at the configured
    factor; the tuned factor never falls below the configured one (the
    tuner may add slack, never drop more tokens).  Both knobs change the
    routing, so logits depend on the tuning cache unless
    ``REPRO_AUTOTUNE=0``."""
    from repro_torch.kernels.autotune import tuned_config
    from repro_torch.kernels.moe_dispatch import tiling

    g_default = math.gcd(B, getattr(cfg, "moe_groups", 32) or 32)
    shape = tiling.shape_key(B, S, cfg.d_model, cfg.n_experts,
                             cfg.experts_per_token, cfg.moe_d_ff_,
                             cfg.capacity_factor, dtype)
    tuned = tuned_config("moe_dispatch", shape,
                         {"groups": g_default,
                          "capacity_factor": cfg.capacity_factor})
    groups = math.gcd(B, int(tuned.get("groups", g_default)) or g_default)
    factor = max(float(tuned.get("capacity_factor", cfg.capacity_factor)),
                 cfg.capacity_factor)
    return groups, factor


def _tuned_ssm_chunk(xh, n_state: int, default_chunk: int) -> int:
    """Chunk length for :func:`ssd_scan`, from the autotuner (the
    ``ssm_scan`` tiling model; on the card its runner times the SSD
    kernel), falling back to the config constant (ref ``layers.py:140``)."""
    from repro_torch.kernels.autotune import tuned_config
    from repro_torch.kernels.ssm_scan import tiling

    shape = tiling.shape_key(xh.shape, n_state, dtype=xh.dtype)
    return int(tuned_config("ssm_scan", shape,
                            {"chunk": default_chunk}).get("chunk",
                                                          default_chunk))


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
    reference.  ``block_q=None`` → autotuned (shared flash-attention
    tiling cache).
    """
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    if _is_dtensor(q) or _is_dtensor(k):
        # each rank attends over its rows and kv-head groups (heads on the
        # model axis only where the kv heads divide it: a GQA group never
        # splits); the mask and the softmax stay on the local shards
        b = _groups_spec(B)[0]
        h = _hint_spec((Hkv,), ("model",))[0]
        act = (b, None, h, None)

        def local(q, k, v, qp, kp, kvl):
            return blocked_attention(q, k, v, q_positions=qp, k_positions=kp,
                                     mask_kind=mask_kind, chunk=chunk,
                                     prefix=prefix, kv_len=kvl, block_q=block_q,
                                     scale=scale)

        rows = lambda t: (b,) if torch.is_tensor(t) and t.ndim > 1 else ()  # noqa: E731
        return _on_shards(local, (q, k, v, q_positions, k_positions, kv_len),
                          (act, act, act, rows(q_positions), rows(k_positions),
                           (b,) if torch.is_tensor(kv_len) and kv_len.ndim else ()),
                          act)
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qr = (q * scale).reshape(B, Sq, Hkv, rep, Dh)
    if block_q is None:
        block_q = _tuned_attention_block_q(q, k, mask_kind != "full")
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
    kv_source=None,      # cross-attention memory (B, Sm, D)
    pos_offset=None,     # (B,) left-padding per row (ragged prompts)
    block_table=None,    # (B, NB) int32 logical→physical block map (paged)
):
    """Attention sublayer: projections + RoPE + attention.

    Returns (out, cache).  ``p`` is an :class:`Attention` module.  With
    ``kv_source`` it is cross-attention: K/V come from the memory, with no
    RoPE, a ``"full"`` mask and no cache (ref ``layers.py:332-334``,
    ``:406-411``).

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

    src = kv_source if kv_source is not None else x
    q, k, v = x @ p.wq, src @ p.wk, src @ p.wv
    if _is_dtensor(q):
        # heads on the model axis only where the kv heads divide it (a GQA
        # group whole on a rank), so that the head split below is a view
        # of each shard
        heads = (_groups_spec(B)[0], None, _hint_spec((Hkv,), ("model",))[0])
        q, k, v = (_constrain_spec(t, heads) for t in (q, k, v))
    q = q.view(B, S, H, Dh)
    k = k.view(B, src.shape[1], Hkv, Dh)
    v = v.view(B, src.shape[1], Hkv, Dh)
    if cfg.attn_bias:
        q = q + p.bq.view(H, Dh)
        k = k + p.bk.view(Hkv, Dh)
        v = v + p.bv.view(Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)

    if kv_source is None:                # self-attention: RoPE on q and k
        rope_pos = positions.clamp_min(0)    # pad slots: masked, not rotated
        q = rope(q, rope_pos, cfg.rope_theta)
        k = rope(k, rope_pos, cfg.rope_theta)
    if kv_source is not None:  # cross-attention: no RoPE, full mask over memory
        k_pos, kv_len = torch.arange(src.shape[1], device=x.device), None
        k_full, v_full = k, v
        mask_kind = "full"
    elif cache is None:
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


def moe_capacity(tokens: int, n_experts: int, k: int, factor: float) -> int:
    c = int(math.ceil(tokens * k / n_experts * factor))
    return max(8, -(-c // 8) * 8)  # multiple of 8, floor 8


def _moe_dispatch_group(xt, ids, E, K, C):
    """Capacity dispatch of every token group at once (the reference
    ``vmap``s its per-group function over them).  xt: (G, T, D); ids:
    (G, T, K).  Returns the (G, E, C, D) expert buffer, built by gathering
    each slot's token, and the route (sorted_e, dest_c, sort_idx), each
    (G, T·K); ``dest_c == C`` marks a dropped (token, expert) pair."""
    G, T, _ = xt.shape
    TK = T * K
    flat_e = ids.reshape(G, TK)
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)     # jnp.argsort is stable
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    experts = torch.arange(E, device=xt.device)
    seg_starts = torch.searchsorted(sorted_e, experts.expand(G, E).contiguous())
    seg_ends = torch.cat([seg_starts[:, 1:], seg_starts.new_full((G, 1), TK)], 1)
    # slot (e, c) holds sorted position seg_starts[e]+c while inside segment
    pos = seg_starts[..., None] + torch.arange(C, device=xt.device)     # (G, E, C)
    valid = pos < seg_ends[..., None]
    tok_for_slot = torch.gather(sort_idx, 1, pos.clamp(0, TK - 1).reshape(G, -1)
                                ).reshape(G, E, C) // K
    rows = torch.arange(G, device=xt.device)[:, None, None]
    buf = torch.where(valid[..., None], xt[rows, tok_for_slot], 0)    # (G, E, C, D)
    pos_in_e = torch.arange(TK, device=xt.device) - torch.gather(seg_starts, 1, sorted_e)
    dest_c = torch.where(pos_in_e < C, pos_in_e, C)                   # C ⇒ dropped
    return buf, (sorted_e, dest_c, sort_idx)


def _moe_combine_group(out_buf, route, gates, K):
    """Each (token, expert) pair's expert output back in token order,
    weighted by its gate and summed over the K experts: (G, T, D).  A
    dropped pair reads index C, the reference's ``mode="fill"`` zero: a
    zero row padded at C."""
    sorted_e, dest_c, sort_idx = route
    G, T = gates.shape[:2]
    filled = F.pad(out_buf, (0, 0, 0, 1))                    # (G, E, C + 1, D)
    rows = torch.arange(G, device=out_buf.device)[:, None]
    slot_out = filled[rows, sorted_e, dest_c]                # (G, T·K, D)
    inv = torch.argsort(sort_idx, dim=-1)                    # a permutation: no ties
    unsorted = slot_out[rows, inv]
    return (unsorted.reshape(G, T, K, -1)
            * gates[..., None].to(out_buf.dtype)).sum(dim=2)


def _top_k(probs, K: int):
    """``lax.top_k``: the K largest along the last axis, descending, the
    lower index first on a tie (a stable descending sort keeps it;
    ``torch.topk`` promises no order among equals)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :K], idx[..., :K]


def moe_block(x, p, cfg):
    """Top-k capacity MoE: GShard-style dispatch, SwiGLU experts.

    Tokens split into ``G`` groups along the batch axis (a leading batch
    dim here); each group sorts its (token, expert) pairs by expert and
    fills an (E, C, ·) buffer, pairs past an expert's capacity C dropped.
    The router runs in f32; the experts are batched products over E.
    Returns (out, aux) with aux the load-balancing loss."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    G, factor = _tuned_moe_dispatch(B, S, cfg, x.dtype)
    Tg = (B // G) * S
    C = moe_capacity(Tg, E, K, factor)
    if _is_dtensor(x):      # groups split the batch: rows on DP only if G divides
        x = _maybe_constrain(x, "dp" if _groups_spec(G)[0] else None, None, None)
    xg = x.reshape(G, Tg, D)

    logits = xg.float() @ p.router.float()                  # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = _top_k(probs, K)                            # (G, Tg, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    buf, route = _per_group(_moe_dispatch_group, xg, ids, E, K, C)  # (G, E, C, D)
    # Expert-parallel layout: groups on DP, experts on the model axis.  The
    # reshard from (G@dp, E) to (G@dp, E@model) IS the GShard all-to-all.
    buf = _maybe_constrain(buf, "dp", "model", None, None)
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, p.gate))
    h = h * torch.einsum("gecd,edf->gecf", buf, p.up)
    h = _maybe_constrain(h, "dp", "model", None, None)
    out_buf = torch.einsum("gecf,efd->gecd", h, p.down)      # (G, E, C, D)
    out_buf = _maybe_constrain(out_buf, "dp", "model", None, None)

    out = _per_group(_moe_combine_group, out_buf, route, gates, K)  # (G, Tg, D)
    out = _maybe_constrain(out, "dp", None, None)
    aux = _load_balance_loss(probs.reshape(-1, E), ids.reshape(-1, K), E)
    return out.reshape(B, S, D), aux


def _load_balance_loss(probs, ids, E):
    """Switch-style auxiliary load-balancing loss (returned for the trainer)."""
    if _is_dtensor(ids):            # the token counts need every rank's ids
        ids = ids.full_tensor()
    counts = torch.zeros(E, device=probs.device).index_add_(
        0, ids.reshape(-1), torch.ones(ids.numel(), device=probs.device))
    frac_tokens = counts / ids.numel()
    frac_probs = probs.mean(dim=0)
    return E * torch.sum(frac_tokens * frac_probs)


# ---------------------------------------------------------------------------
# Mamba-2 SSD mixer: the chunked scan (also the SSD kernel's oracle), the block
# ---------------------------------------------------------------------------


def _segsum(a):
    """Stable segment-sum: out[..., i, j] = sum a[..., j+1..i], -inf for j>i."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=a.device))
    return torch.where(mask, out, -torch.inf)


def ssd_scan(xh, a, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD (Mamba-2 alg. 1 / "minimal ssd"), in plain PyTorch.

    xh: (B, S, H, P) inputs (already dt-scaled)
    a:  (B, S, H)    log-decay per step (dt · A, negative)
    Bm, Cm: (B, S, G, N) state in/out projections (G groups, broadcast to H)
    Returns y: (B, S, H, P) in xh's dtype, final_state: (B, H, P, N) f32.
    Products are taken in f32, as the reference's
    ``preferred_element_type=float32`` einsums; its ``lax.scan`` over
    chunks is a Python loop.
    """
    B, S0, H, P = xh.shape
    G = Bm.shape[2]
    pad = (-S0) % chunk
    if pad:  # zero-pad: a=0 ⇒ decay 1, x=0 ⇒ no state contribution
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    S = S0 + pad
    nc = S // chunk
    rep = H // G

    def c(t):  # (B, S, ...) -> (B, nc, chunk, ...)
        return t.reshape(t.shape[0], nc, chunk, *t.shape[2:])

    xc, ac, Bc, Cc = c(xh).float(), c(a), c(Bm).float(), c(Cm).float()
    ac = ac.movedim(-1, 2)                  # (B, nc, H, chunk)
    cum_a = torch.cumsum(ac, dim=-1)        # (B, nc, H, chunk)

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(ac.float()))                            # (B,nc,H,l,l)
    Cr = Cc.repeat_interleave(rep, dim=3) if G != H else Cc       # broadcast groups
    Br = Bc.repeat_interleave(rep, dim=3) if G != H else Bc
    s = torch.einsum("bclhn,bcshn->bchls", Cr, Br)
    y_diag = torch.einsum("bchls,bchls,bcshp->bclhp", s, L, xc)

    # 2. per-chunk final states
    decay_states = torch.exp(cum_a[..., -1:] - cum_a)             # (B,nc,H,l)
    states = torch.einsum("bclhn,bchl,bclhp->bchpn", Br,
                          decay_states.float(), xc)               # (B,nc,H,P,N)

    # 3. inter-chunk recurrence (the reference's lax.scan over chunks)
    chunk_decay = torch.exp(cum_a[..., -1]).float()               # (B,nc,H)
    carry = (initial_state.float() if initial_state is not None
             else torch.zeros(B, H, P, Bm.shape[3], device=xh.device))
    prev = []
    for i in range(nc):
        prev.append(carry)              # the state entering chunk i
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                        # (B,nc,H,P,N)

    # 4. state → output contribution
    state_decay = torch.exp(cum_a).float()                        # (B,nc,H,l)
    y_off = torch.einsum("bclhn,bchpn,bchl->bclhp", Cr, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(B, S, H, P)[:, :S0]
    return y.to(xh.dtype), carry


def _sharded_scan(xh, a, Bm, Cm, chunk: int, initial_state=None):
    """:func:`ssd_scan`, on each rank's rows and heads under a hint mesh
    (the scan's chunk reshapes are local: DTensor cannot split a
    sequence-parallel shard into chunks); plain tensors: ``ssd_scan``."""
    if not _is_dtensor(xh):
        return ssd_scan(xh, a, Bm, Cm, chunk, initial_state=initial_state)
    b = _groups_spec(xh.shape[0])[0]
    h = _hint_spec(xh.shape[2:3], ("model",))[0]

    def local(xh, a, Bm, Cm, st):
        return ssd_scan(xh, a, Bm, Cm, chunk, initial_state=st)

    return _on_shards(local, (xh, a, Bm, Cm, initial_state),
                      ((b, None, h, None), (b, None, h), (b,), (b,), (b, h)),
                      [(b, None, h, None), (b, h)])


def _ssd_step(xh, a, Bm, Cm, state):
    """One step of the SSD recurrence (S == 1), in f32: the new state and
    its output y (B, 1, H, P)."""
    H, G = xh.shape[2], Bm.shape[2]
    st = state.float()                                       # (B,H,P,N)
    dec = torch.exp(a[:, 0])                                 # (B,H)
    Br = Bm[:, 0].repeat_interleave(H // G, dim=1) if G != H else Bm[:, 0]
    Cr = Cm[:, 0].repeat_interleave(H // G, dim=1) if G != H else Cm[:, 0]
    upd = torch.einsum("bhp,bhn->bhpn", xh[:, 0].float(), Br.float())
    st = st * dec[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", st, Cr.float())[:, None]
    return y, st


def _sharded_step(xh, a, Bm, Cm, state):
    """:func:`_ssd_step` on each rank's rows and heads under a hint mesh
    (its einsums flatten the head dim, which DTensor may refuse to do
    over a shard); plain tensors: ``_ssd_step``."""
    if not _is_dtensor(xh):
        return _ssd_step(xh, a, Bm, Cm, state)
    b = _groups_spec(xh.shape[0])[0]
    h = _hint_spec(xh.shape[2:3], ("model",))[0]
    return _on_shards(_ssd_step, (xh, a, Bm, Cm, state),
                      ((b, None, h, None), (b, None, h), (b,), (b,), (b, h)),
                      [(b, None, h, None), (b, h)])


def ssd_block(x, p, cfg, *, cache=None, valid=None):
    """Mamba-2 block: in_proj → causal conv1d → SSD → gated norm → out_proj.

    cache: {"conv": (B, W-1, d_conv_ch), "state": (B, H, P, N) f32}, both
    written in place (the new conv taps and the final state).  ``valid``
    (B, S) bool marks real tokens of a left-padded ragged batch: invalid
    steps feed zero conv taps, zero state input and unit decay (a = 0),
    so the recurrence matches an unpadded run exactly.  S == 1 with a
    cache is the single-step recurrence, in f32.  Returns (out, cache).
    """
    B, S, _ = x.shape
    d_inner, H, P, N, _ = ssm_dims(cfg)
    G = 1  # single B/C group
    W = cfg.ssm_conv_width

    z = x @ p.w_z
    xbc = torch.cat([x @ p.w_x, x @ p.w_B, x @ p.w_C], dim=-1)
    # the conv's channels whole on every rank (the identity unsharded):
    # some DTensor releases cannot pad a tensor sharded on another dim
    xbc = _maybe_constrain(xbc, "dp", None, None)
    dt = F.softplus((x @ p.w_dt).float() + p.dt_bias.float())
    if valid is not None:  # pad steps feed zero taps into the causal conv
        xbc = torch.where(valid[..., None], xbc, 0)

    # causal depthwise conv over (x, B, C) channels
    if cache is None:
        conv_in = F.pad(xbc, (0, 0, W - 1, 0))
    else:
        conv_in = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)
        cache["conv"].copy_(conv_in[:, -(W - 1):])
    acc = 0
    for i in range(W):
        acc = acc + conv_in[:, i:i + S] * p.conv_w[i]
    xbc = F.silu(acc + p.conv_b)

    xs, Bm, Cm = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)
    A = -torch.exp(p.A_log.float())                          # (H,), negative
    a = dt * A                                               # (B,S,H) log-decay
    xh = xs * dt[..., None].to(xs.dtype)
    if valid is not None:  # pad steps: no state input, unit decay
        xh = torch.where(valid[..., None, None], xh, 0)
        a = torch.where(valid[..., None], a, 0.0)

    chunk = _tuned_ssm_chunk(xh, N, cfg.ssm_chunk) if S > 1 else cfg.ssm_chunk
    if cache is None:
        y, _ = _sharded_scan(xh, a, Bm, Cm, chunk)
    elif S > 1:  # prefill with cache: chunked scan seeded by the cached state
        y, final_state = _sharded_scan(xh, a, Bm, Cm, chunk, cache["state"])
        cache["state"].copy_(final_state)
    else:        # single-step recurrence (S == 1)
        y, st = _sharded_step(xh, a, Bm, Cm, cache["state"])
        cache["state"].copy_(st)

    y = y + xs.to(y.dtype) * p.D.to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.norm)                      # gated RMSNorm
    return y @ p.out_proj, cache
