"""Layout-level collective-traffic and memory-split accounting (port of
``repro/distributed/collectives.py``, whole).

One function — :func:`layout_collectives` — turns ``(ArchConfig ×
ShapeSpec × mesh)`` into the per-device, per-class collective bytes a
training/inference step moves under the repo's own sharding rules
(``distributed/sharding.py``), plus the per-device memory split the same
rules imply.  Everything is derived from the partition specs via
:func:`~repro_torch.distributed.sharding.describe_sharding`, so the
accounting can never drift from the rules; **replication fallbacks are
priced, not silently accepted** — a leaf the rules wanted model-sharded
but had to replicate contributes an extra model-axis gradient all-reduce
and keeps its unsplit memory.

Numpy/stdlib only: the planner prices hundreds of layouts for meshes far
larger than the host with no device.  ``abstract_mesh`` builds the mesh
stand-in the sharding rules need (``axis_names`` + ``devices.shape``)
without touching device state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.pipeline_parallel import bubble_fraction

__all__ = [
    "COLLECTIVE_CLASSES",
    "abstract_mesh",
    "LayoutCollectives",
    "layout_collectives",
]

_BYTES_PER_EL = {"bfloat16": 2, "float16": 2, "float32": 4}

# The collective classes the accounting buckets bytes into.  ``all_reduce``
# carries DP gradient rings, TP activation reductions AND the replication
# penalty; ``all_gather``/``reduce_scatter`` are the ZeRO/FSDP pair;
# ``ppermute`` is the pipeline's stage-boundary activation forwarding.
COLLECTIVE_CLASSES: tuple[str, ...] = (
    "all_reduce", "all_gather", "reduce_scatter", "ppermute",
)


def abstract_mesh(dims, axes=None) -> SimpleNamespace:
    """A mesh stand-in carrying exactly what the pspec rules read
    (``axis_names``, ``devices.shape``) — lets the planner price a
    256-device layout on a 1-CPU host without any device state."""
    dims = tuple(int(d) for d in dims)
    if axes is None:
        axes = ("pod", "data", "model")[-len(dims):]
    axes = tuple(axes)
    if len(axes) != len(dims):
        raise ValueError(f"mesh dims {dims} vs axes {axes} length mismatch")
    n = 1
    for d in dims:
        n *= d
    return SimpleNamespace(
        axis_names=axes,
        devices=SimpleNamespace(shape=dims, size=n),
    )


@dataclass
class LayoutCollectives:
    """Per-device collective bytes (one training/inference step) and the
    per-device memory split a layout implies.

    ``per_class`` keys are :data:`COLLECTIVE_CLASSES`; ``memory`` carries
    ``param_bytes_dev / grad_bytes_dev / opt_bytes_dev / act_bytes_dev /
    kv_bytes_dev / total_bytes_dev / param_bytes_total /
    replicated_bytes``; ``replicated`` lists the leaf paths whose wanted
    model-axis shard fell back to replication (priced via the extra
    model-axis all-reduce in ``per_class["all_reduce"]``)."""

    per_class: dict = field(default_factory=dict)
    memory: dict = field(default_factory=dict)
    replicated: list = field(default_factory=list)
    replicated_fraction: float = 0.0
    bubble: float = 0.0
    fsdp: bool = False

    @property
    def total_bytes(self) -> float:
        return float(sum(self.per_class.values()))

    def to_dict(self) -> dict:
        return {
            "per_class": {k: float(v) for k, v in self.per_class.items()},
            "total_bytes": self.total_bytes,
            "memory": {k: float(v) for k, v in self.memory.items()},
            "replicated": list(self.replicated),
            "replicated_fraction": float(self.replicated_fraction),
            "bubble": float(self.bubble),
            "fsdp": bool(self.fsdp),
        }


def layout_collectives(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh,
    *,
    pipe: int = 1,
    n_micro: int = 1,
    fsdp: bool | None = None,
    bytes_per_el: int | None = None,
) -> LayoutCollectives:
    """Account one step's per-device collective bytes + memory split for
    ``cfg × shape`` sharded on ``mesh`` (with ``pipe`` pipeline stages
    splitting the layer stack outside the mesh axes).

    All byte counts come from walking the real PartitionSpecs:

    * **DP gradient ring all-reduce** — ``2·B·(d−1)/d`` per device over the
      data axes, where ``B`` is the per-model-shard gradient bytes (the
      classic ring cost); replaced by the reduce-scatter + all-gather pair
      under ZeRO/FSDP.
    * **TP activation all-reduces** — two per layer forward (attention out,
      FFN out), doubled for backward on train cells, each moving the
      per-device activation slab ``(m−1)/m``-scaled.
    * **Replication penalty** — leaves whose wanted model shard fell back
      to replication gradient-all-reduce over the *model* axis too (each
      model-axis replica computed partial grads for them): priced, never
      silently dropped.
    * **Pipeline ppermute** — stage-boundary activation forwarding,
      fwd+bwd, ``(p−1)/p``-scaled.
    """
    bpe = bytes_per_el or _BYTES_PER_EL.get(cfg.dtype, 2)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    d_par = 1
    for ax in ("pod", "data"):
        d_par *= int(sizes.get(ax, 1))
    m_par = int(sizes.get("model", 1))
    pipe = max(int(pipe), 1)
    if fsdp is None:
        fsdp = sh.fsdp_wanted(cfg, mesh)
    train = shape.kind == "train"

    leaves = sh.describe_sharding(cfg, mesh, fsdp=fsdp)
    param_total = grad_dev = param_dev = repl_bytes_dev = 0.0
    replicated: list[str] = []
    for lf in leaves:
        nbytes = lf.elements * bpe
        param_total += nbytes
        param_dev += nbytes / lf.shard
        # Gradients mirror the TP shard (model axis) but are summed over
        # the data axes, so per-device grad bytes divide by model only —
        # exactly the tensor each DP ring round-trips.
        grad_dev += nbytes / max(lf.model_shard, 1)
        if lf.replicated_model:
            replicated.append(lf.path)
            repl_bytes_dev += nbytes  # unsplit on every model-axis device

    # Pipeline stages split the layer stack; embeddings/head don't split,
    # but at the accounting granularity here the 1/pipe factor on the
    # per-device totals is the intended first-order effect.
    param_dev /= pipe
    grad_dev /= pipe
    repl_dev = repl_bytes_dev / pipe

    # Optimizer state: AdamW m/v in f32, sharded by the param spec plus the
    # ZeRO extension over the data axis (state_pspecs always applies it).
    opt_dev = 0.0
    probe_state = sh.describe_sharding(cfg, mesh, fsdp=True)
    for lf in probe_state:
        opt_dev += 2 * 4 * lf.elements / lf.shard
    opt_dev /= pipe

    # Activations: the coarse lm_features slab (tokens × d_model × layers),
    # batch-sharded over DP when divisible, layer-sharded over pipe.
    tokens = shape.tokens if shape.kind != "decode" else shape.global_batch
    dp_ok = shape.global_batch % max(d_par, 1) == 0
    tokens_dev = tokens / (d_par if dp_ok else 1)
    act_dev = bpe * tokens_dev * cfg.d_model * max(cfg.n_layers, 1) / pipe

    kv_dev = 0.0
    if shape.kind != "train":
        kv_len = shape.seq_len + cfg.n_prefix
        kv_dev = (2.0 * bpe * (shape.global_batch / (d_par if dp_ok else 1))
                  * kv_len * max(cfg.n_kv_heads, 1) * cfg.head_dim_
                  * max(cfg.n_layers, 1) / max(m_par, 1)) / pipe

    per_class = {cls: 0.0 for cls in COLLECTIVE_CLASSES}

    # DP gradient exchange (train only): ring all-reduce, or the ZeRO
    # reduce-scatter + all-gather pair when params are FSDP-sharded.
    if train and d_par > 1:
        ring = (d_par - 1) / d_par
        if fsdp:
            per_class["reduce_scatter"] += grad_dev * ring
            per_class["all_gather"] += param_dev * ring
        else:
            per_class["all_reduce"] += 2.0 * grad_dev * ring

    # TP activation all-reduces: 2 per layer forward, ×2 for backward.
    if m_par > 1:
        n_ar = (4.0 if train else 2.0) * max(cfg.n_layers, 1) / pipe
        per_class["all_reduce"] += (
            n_ar * bpe * tokens_dev * cfg.d_model * (m_par - 1) / m_par)

    # Replication penalty: wanted-but-replicated leaves sum partial grads
    # over the model axis (train) — the fallback's price.
    if train and m_par > 1 and repl_dev > 0:
        per_class["all_reduce"] += 2.0 * repl_dev * (m_par - 1) / m_par

    # Pipeline stage-boundary activation forwarding (fwd + bwd on train).
    bubble = bubble_fraction(pipe, max(n_micro, 1)) if pipe > 1 else 0.0
    if pipe > 1:
        per_class["ppermute"] += ((2.0 if train else 1.0) * bpe * tokens_dev
                                  * cfg.d_model * (pipe - 1) / pipe)

    total_dev = param_dev + act_dev + kv_dev + (
        (grad_dev + opt_dev) if train else 0.0)
    return LayoutCollectives(
        per_class=per_class,
        memory={
            "param_bytes_dev": param_dev,
            "grad_bytes_dev": grad_dev if train else 0.0,
            "opt_bytes_dev": opt_dev if train else 0.0,
            "act_bytes_dev": act_dev,
            "kv_bytes_dev": kv_dev,
            "total_bytes_dev": total_dev,
            "param_bytes_total": param_total,
            "replicated_bytes_dev": repl_dev,
        },
        replicated=replicated,
        replicated_fraction=(repl_bytes_dev / param_total if param_total
                             else 0.0),
        bubble=bubble,
        fsdp=bool(fsdp),
    )
