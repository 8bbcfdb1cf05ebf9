"""Sharding rules: DP (+pod) × TP (+EP) partition specs for every
parameter, batch input, cache and optimizer-state leaf, per architecture
(port of ``repro/distributed/sharding.py``).

Conventions (the reference's DESIGN.md §6):
  * "model" axis: attention heads / FFN hidden / vocab / experts / SSD heads.
  * "data" axis:  batch (training & batched decode); KV-cache sequence for the
    single-sequence long-context cell; ZeRO/FSDP shard of opt-state & (for
    very large archs) parameters.
  * "pod" axis:   outermost data parallelism (gradient all-reduce crosses DCI).

Every rule checks divisibility against the actual mesh axis size and falls
back to replication — a 40-head arch on a 16-way model axis replicates heads
rather than producing an invalid spec (recorded by ``describe_sharding``).

A spec is a plain tuple with one entry per dimension (an axis name, a
tuple of axis names, or None), normalised as the reference's
``PartitionSpec`` normalises its entries: an empty tuple is None and a
one-name tuple is the name.  Trees are nested dicts over
``models/transformer._shape_tree`` and ``cache_shapes``, walked by sorted
key as the reference's pytree flattening walks them; a leaf's ``path`` is
its keys joined by dots.  ``mesh`` is anything with ``axis_names`` and
``devices.shape`` (``collectives.abstract_mesh``) or a
``torch.distributed`` ``DeviceMesh``.

:func:`to_named` turns a spec tree into :class:`NamedSharding` leaves on a
``DeviceMesh`` — the DTensor placements of each leaf, the reference's
``jax.sharding.NamedSharding`` — and :func:`distribute_tree` places a
state, batch or cache tree by them (the reference's ``in_shardings`` /
``jax.device_put``).  :func:`port_params` re-keys a parameter-shaped tree
from the reference's stacked paths to the port's parameter names.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import axis_names, dp_axes
from repro_torch.models import transformer as T

__all__ = [
    "param_pspecs",
    "batch_pspecs",
    "cache_pspecs",
    "state_pspecs",
    "to_named",
    "NamedSharding",
    "distribute_tree",
    "port_params",
    "train_state_shardings",
    "placements",
    "fsdp_wanted",
    "LeafSharding",
    "describe_sharding",
]

_STACKS = ("blocks", "encoder")


def P(*entries) -> tuple:
    """A partition spec as a tuple, normalised like ``PartitionSpec``."""
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return tuple(out)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a dict tree of shape tuples, by sorted key."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,)) for k in sorted(tree)}
    return fn(path, tree)


def _mesh_shape(mesh) -> tuple[int, ...]:
    """The axis sizes of a ``DeviceMesh`` or of an abstract mesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(int(d) for d in mesh.mesh.shape)
    return tuple(mesh.devices.shape)


def _axis(mesh, name: str) -> int:
    return dict(zip(axis_names(mesh), _mesh_shape(mesh))).get(name, 1)


def _dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= _axis(mesh, a)
    return n


def _maybe(axis_name: str, dim: int, mesh) -> str | None:
    """axis_name if dim divides evenly on the mesh, else None (replicate)."""
    sz = _axis(mesh, axis_name)
    return axis_name if sz > 1 and dim % sz == 0 else None


def _stacked(path) -> bool:
    return any(p in _STACKS for p in path)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _param_rule(name: str, shape: tuple[int, ...], stacked: bool, mesh, cfg) -> tuple:
    """Partition spec for one parameter leaf (shape includes the stack dim
    when ``stacked``)."""
    s = shape[1:] if stacked else shape
    lead = (None,) if stacked else ()

    def spec(*dims):
        return P(*lead, *dims)

    m = "model"
    if name == "embed":
        return spec(_maybe(m, s[0], mesh), None)
    if name == "lm_head":
        return spec(None, _maybe(m, s[1], mesh))
    if name in ("wq",):
        return spec(None, _maybe(m, s[1], mesh))
    if name in ("wk", "wv"):
        return spec(None, _maybe(m, s[1], mesh))
    if name == "wo":
        return spec(_maybe(m, s[0], mesh), None)
    if name in ("gate", "up"):
        if len(s) == 3:  # MoE expert (E, D, F): expert-parallel
            return spec(_maybe(m, s[0], mesh), None, None)
        return spec(None, _maybe(m, s[1], mesh))
    if name == "down":
        if len(s) == 3:  # (E, F, D)
            return spec(_maybe(m, s[0], mesh), None, None)
        return spec(_maybe(m, s[0], mesh), None)
    if name == "router":
        return spec(None, None)
    if name in ("w_z", "w_x"):
        return spec(None, _maybe(m, s[1], mesh))
    if name == "out_proj":
        return spec(_maybe(m, s[0], mesh), None)
    if name in ("bq",):
        return spec(_maybe(m, s[0], mesh))
    # small/replicated: norms, biases, router, conv, dt/A/D, w_B, w_C, w_dt
    return spec(*([None] * len(s)))


def param_pspecs(cfg: ArchConfig, mesh, *, fsdp: bool = False) -> dict:
    def leaf(path, shape):
        spec = _param_rule(path[-1], shape, _stacked(path), mesh, cfg)
        if fsdp:
            spec = _zero_extend(spec, shape, mesh)
        return spec

    return _map_with_path(leaf, T._shape_tree(cfg))


def fsdp_wanted(cfg: ArchConfig, mesh, hbm_budget_gb: float = 8.0) -> bool:
    """FSDP the parameters when the TP-sharded copy alone would eat more than
    ``hbm_budget_gb`` per device."""
    m = _axis(mesh, "model")
    return cfg.param_count() * 2 / m > hbm_budget_gb * 1e9


# ---------------------------------------------------------------------------
# ZeRO extension (optimizer state / FSDP params)
# ---------------------------------------------------------------------------


def _zero_extend(spec: tuple, shape: tuple[int, ...], mesh, axis: str = "data") -> tuple:
    """Shard the largest still-replicated dim over ``axis`` (ZeRO-style)."""
    sz = _axis(mesh, axis)
    if sz <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = -1, -1
    for i, (e, d) in enumerate(zip(entries, shape)):
        if e is None and d % sz == 0 and d > best_dim:
            best, best_dim = i, d
    if best >= 0:
        entries[best] = axis
    return P(*entries)


def state_pspecs(cfg: ArchConfig, mesh, *, kind: str = "adamw",
                 fsdp: bool | None = None) -> dict:
    fsdp = fsdp_wanted(cfg, mesh) if fsdp is None else fsdp
    ps = param_pspecs(cfg, mesh, fsdp=fsdp)
    slots = _map_with_path(
        lambda path, shape: _zero_extend(
            _param_rule(path[-1], shape, _stacked(path), mesh, cfg), shape, mesh),
        T._shape_tree(cfg))
    opt = {"step": P(), "m": slots}
    if kind == "adamw":
        opt["v"] = slots
    return {"params": ps, "opt": opt}


# ---------------------------------------------------------------------------
# Batch & cache
# ---------------------------------------------------------------------------


def batch_pspecs(cfg: ArchConfig, shape: ShapeSpec, mesh) -> dict:
    dp = dp_axes(mesh)
    dp_ok = shape.global_batch % _dp_size(mesh) == 0
    b = dp if dp_ok else None
    specs: dict = {"tokens": P(b, None)}
    if shape.kind in ("train", "prefill"):
        if cfg.n_prefix:
            specs["patches"] = P(b, None, None)
        if cfg.n_encoder_layers:
            specs["frames"] = P(b, None, None)
    else:
        specs["tokens"] = P(b, None)
        specs["cache_len"] = P()
        if cfg.n_encoder_layers:
            specs["memory"] = P(b, None, None)
    return specs


def cache_pspecs(cfg: ArchConfig, shape: ShapeSpec, mesh) -> dict:
    """Decode-cache specs.  Batched decode shards batch over DP; the
    single-sequence long-context cell shards the KV sequence dim over data
    (sequence parallelism for cache reads)."""
    dp = dp_axes(mesh)
    dp_ok = shape.global_batch % _dp_size(mesh) == 0
    b = dp if dp_ok else None
    seq = None if dp_ok else _maybe("data", shape.seq_len, mesh)

    def leaf(path, s):
        name = path[-1]
        if name in ("k", "v"):      # (n, B, S, Hkv, Dh)
            return P(None, b, seq, _maybe("model", s[3], mesh), None)
        if name == "state":          # (n, B, H, P, N)
            return P(None, b, _maybe("model", s[2], mesh), None, None)
        if name == "conv":           # (n, B, W-1, d_conv_ch)
            return P(None, b, None, None)
        raise KeyError(name)

    return _map_with_path(
        leaf, T.cache_shapes(cfg, shape.global_batch, shape.seq_len))


# ---------------------------------------------------------------------------
# Placements on a DeviceMesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NamedSharding:
    """One leaf's layout on a ``DeviceMesh``: the DTensor placements (one
    per mesh dim) that its partition spec resolves to."""

    mesh: object
    placements: tuple
    spec: tuple


def placements(mesh, spec: tuple) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: an axis name puts
    ``Shard(dim)`` on that mesh dim, a tuple of names shards one dim over
    several mesh dims (major first, as in the mesh), every other mesh dim
    is ``Replicate()``.  A mesh dim of size 1 stays ``Replicate()`` (the
    same layout: its one shard is the whole dim), which keeps DTensor's
    view rules from refusing to flatten a dim "sharded" one way."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    sizes = _mesh_shape(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims of {spec}")
            if sizes[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def to_named(mesh, spec_tree):
    """The :class:`NamedSharding` of every spec in a tree of dicts."""
    if isinstance(spec_tree, dict):
        return {k: to_named(mesh, v) for k, v in spec_tree.items()}
    if not _is_spec(spec_tree):
        raise TypeError(f"not a partition spec: {spec_tree!r}")
    return NamedSharding(mesh, placements(mesh, spec_tree), spec_tree)


def port_params(cfg: ArchConfig, ref_tree) -> dict:
    """``{port parameter name: leaf}`` of a parameter-shaped tree keyed by
    the reference's paths (``param_pspecs``, ``state_pspecs``' slots).  A
    stacked leaf serves every scan step, less its leading stack entry."""
    out = {}
    for path, shape in T.param_leaves(cfg):
        leaf = ref_tree
        for k in path:
            leaf = leaf[k]
        if path[0] in ("blocks", "encoder"):
            for layer in range(shape[0]):
                out[T.param_name(cfg, path, layer)] = leaf[1:]
        else:
            out[T.param_name(cfg, path)] = leaf
    return out


def train_state_shardings(cfg: ArchConfig, mesh, *, kind: str = "adamw",
                          fsdp: bool | None = None, err: bool = False) -> dict:
    """The port's train state ``{"params", "opt": {"step", "m"[, "v"]}
    [, "err"]}`` as :class:`NamedSharding` leaves: :func:`state_pspecs`
    re-keyed by parameter name (the compression residual ``err`` laid out
    as the parameters)."""
    spec = state_pspecs(cfg, mesh, kind=kind, fsdp=fsdp)
    params = port_params(cfg, spec["params"])
    opt = {"step": spec["opt"]["step"]}
    for slot in ("m", "v"):
        if slot in spec["opt"]:
            opt[slot] = port_params(cfg, spec["opt"][slot])
    tree = {"params": params, "opt": opt}
    if err:
        tree["err"] = dict(params)
    return to_named(mesh, tree)


def _distribute(t: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    """``t`` — the whole tensor, the same on every rank — as a DTensor:
    this rank's slice of it, cut locally (no collective: the state, batch
    and checkpoint leaves the port places are made alike on every rank,
    and under ``launch.mesh.fake_world`` a scatter would leave the shard
    unwritten).  A DTensor is redistributed."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if isinstance(t, DTensor):
        return t.redistribute(sh.mesh, sh.placements)
    if not t.is_meta and t.device.type != sh.mesh.device_type:
        t = t.to(sh.mesh.device_type)
    local_shape, offset = compute_local_shape_and_global_offset(
        t.shape, sh.mesh, list(sh.placements))
    local = t
    for dim, (start, size) in enumerate(zip(offset, local_shape)):
        if size != t.shape[dim]:
            local = local.narrow(dim, start, size)
    # a copy of the slice, never a view: a narrow of dim 0 alone is
    # already contiguous, and the shard would keep the whole tensor's storage
    local = local.clone(memory_format=torch.contiguous_format) if local is not t else t
    return DTensor.from_local(local, sh.mesh, list(sh.placements), run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_tree(tree, shardings):
    """Place a state, batch or cache tree on its shardings: every tensor
    becomes a ``DTensor`` of this rank's slice (``_distribute``: the
    whole tensor must be the same on every rank; a ``DTensor`` is
    redistributed), every other
    leaf (an int ``cache_len``) is kept.  An ``nn.Module`` leaf (the
    model) takes a ``{parameter name: NamedSharding}`` dict and has its
    parameters replaced in place by ``DTensor`` parameters, with their
    ``requires_grad``."""
    if isinstance(tree, torch.nn.Module):
        for name, sh in shardings.items():
            mod, _, leaf = name.rpartition(".")
            owner = tree.get_submodule(mod) if mod else tree
            p = getattr(owner, leaf)
            setattr(owner, leaf, torch.nn.Parameter(
                _distribute(p.detach(), sh), requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, dict):
        return {k: (distribute_tree(v, shardings[k]) if k in shardings else v)
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return _distribute(tree, shardings)
    return tree


# ---------------------------------------------------------------------------
# Introspection: what did the rules decide, and where did they fall back?
# ---------------------------------------------------------------------------


class _ProbeSize:
    """Axis-size stand-in that passes every ``_maybe`` check (``> 1`` is
    True, every ``dim %`` is 0).  Probing ``_param_rule`` with it reveals
    which leaves the rule *wants* to shard on an axis, independent of
    whether the real axis size divides the leaf dims — the ground truth
    for "replicated as a fallback" vs "replicated by design"."""

    def __gt__(self, other):
        return True

    def __rmod__(self, other):
        return 0


def _probe_mesh(axis_names) -> SimpleNamespace:
    return SimpleNamespace(
        axis_names=tuple(axis_names),
        devices=SimpleNamespace(shape=tuple(_ProbeSize() for _ in axis_names)),
    )


@dataclass(frozen=True)
class LeafSharding:
    """One parameter leaf's sharding decision on a concrete mesh."""

    path: str
    shape: tuple
    elements: int
    spec: tuple            # applied spec entries (len == len(shape))
    wanted: tuple          # entries the rule would pick if everything divided
    shard: int             # product of applied mesh-axis sizes
    model_shard: int       # applied "model"-axis factor only
    data_shard: int        # applied "pod"/"data"-axis factor only
    replicated_model: bool  # model sharding wanted but fell back to replicate


def _entries(spec: tuple, ndim: int) -> tuple:
    e = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return e[:ndim]


def describe_sharding(cfg: ArchConfig, mesh, *, fsdp: bool | None = None
                      ) -> list[LeafSharding]:
    """Per-leaf report of :func:`param_pspecs` on ``mesh``: the applied
    spec, the spec the rules *wanted* (probed with an always-divisible
    axis size), and whether the model-axis fallback to replication fired.

    This is the accounting substrate for
    :func:`repro_torch.distributed.collectives.layout_collectives`: the
    planner prices replication fallbacks from here instead of silently
    accepting them.  Leaves come in the reference's order."""
    fsdp = fsdp_wanted(cfg, mesh) if fsdp is None else fsdp
    probe = _probe_mesh(axis_names(mesh))
    sizes = dict(zip(axis_names(mesh), _mesh_shape(mesh)))
    model_sz = int(sizes.get("model", 1))
    out: list[LeafSharding] = []

    def leaf(path, shape):
        name, stacked = path[-1], _stacked(path)
        spec = _param_rule(name, shape, stacked, mesh, cfg)
        if fsdp:
            spec = _zero_extend(spec, shape, mesh)
        want = _param_rule(name, shape, stacked, probe, cfg)
        applied = _entries(spec, len(shape))
        wanted = _entries(want, len(shape))
        shard = model_shard = data_shard = 1
        for ax in applied:
            if ax is None:
                continue
            sz = int(sizes.get(ax, 1))
            shard *= sz
            if ax == "model":
                model_shard *= sz
            elif ax in ("pod", "data"):
                data_shard *= sz
        n = 1
        for d in shape:
            n *= int(d)
        out.append(LeafSharding(
            path=".".join(path),
            shape=tuple(int(d) for d in shape),
            elements=n,
            spec=applied,
            wanted=wanted,
            shard=shard,
            model_shard=model_shard,
            data_shard=data_shard,
            replicated_model=(model_sz > 1 and "model" in wanted
                              and "model" not in applied),
        ))
        return spec

    _map_with_path(leaf, T._shape_tree(cfg))
    return out
