"""Per-collective byte counts for the roofline model (port of
``repro/core/hlo_analysis.py``).

Two halves, one byte model:

* :func:`analyze_hlo_collectives` / :class:`CollectiveStats` — the
  reference's parser of optimized (post-SPMD) HLO text, copied whole: it
  is framework-free, and the port's tests hold it exactly against the
  reference on the same HLO lines;
* :func:`collective_stats_from_ops` — the same ring model applied to the
  ``torch.distributed`` collectives a trace of a sharded step records
  (``core/hlo_cost.trace_cost``): the ``_c10d_functional`` ops DTensor
  issues (``all_gather_into_tensor``, ``all_reduce``,
  ``reduce_scatter_tensor``, ``all_to_all_single``, ``broadcast``),
  DTensor's own ``shard_dim_alltoall`` and the point-to-point
  ``send``/``recv`` of the pipeline schedule.  ``g`` is the size of the
  op's process group.

Byte model per op kind (ring algorithms, g = replica-group size, S = result
buffer bytes on one device):

  all-gather        : device receives S·(g−1)/g  ≈ S bytes
  reduce-scatter    : operand is g·S; device sends/receives (g−1)·S ≈ input bytes
  all-reduce        : ring RS+AG ⇒ 2·S·(g−1)/g   ≈ 2·S bytes
  all-to-all        : device exchanges S·(g−1)/g ≈ S bytes
  collective-permute: S bytes

These are the standard ring-collective costs; exact (g−1)/g factors are
applied when the replica-group size is parseable from the op attributes.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

__all__ = ["CollectiveStats", "analyze_hlo_collectives", "DTYPE_BYTES",
           "collective_kind", "ring_bytes", "collective_stats_from_ops"]

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16, "token": 0,
}

# e.g.  %all-gather.3 = bf16[16,128]{1,0} all-gather(%param.1), ...
_OP_RE = re.compile(
    r"=\s*(?:\()?\s*([a-z0-9]+)\[([0-9,]*)\][^ ]*\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\("
)
_TUPLE_OP_RE = re.compile(
    r"=\s*\(((?:[a-z0-9]+\[[0-9,]*\][^,)]*,?\s*)+)\)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{?\{([0-9,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


@dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, float] = field(default_factory=dict)
    count_by_kind: dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, nbytes: float) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1


def _shape_bytes(dtype: str, dims: str) -> float:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * DTYPE_BYTES.get(dtype, 4)


def _group_size(line: str) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:  # replica_groups=[ngroups,gsize]<=...
        return max(int(m.group(2)), 1)
    m = _GROUPS_RE.search(line)
    if m:
        return max(len(m.group(1).split(",")), 1)
    return 2  # unknown: assume ≥2 so the (g-1)/g factor ≈ 0.5..1


def analyze_hlo_collectives(hlo_text: str) -> CollectiveStats:
    """Sum per-device collective bytes from optimized HLO text."""
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        if "fusion" in line and "calls=" in line:
            pass  # collectives never hide inside fusions
        m = _OP_RE.search(line)
        shapes: list[tuple[str, str]] = []
        kind = None
        if m:
            kind = m.group(3)
            shapes = [(m.group(1), m.group(2))]
        else:
            mt = _TUPLE_OP_RE.search(line)
            if mt:
                kind = mt.group(2)
                shapes = _SHAPE_RE.findall(mt.group(1))
        if not kind:
            continue
        out_bytes = sum(_shape_bytes(dt, dims) for dt, dims in shapes)
        stats.add(kind, ring_bytes(kind, out_bytes, _group_size(line)))
    return stats


def ring_bytes(kind: str, out_bytes: float, g: int) -> float:
    """Per-device bytes one collective of ``kind`` moves (the module
    docstring's ring model): ``out_bytes`` is its result on one device,
    ``g`` its group size."""
    frac = (g - 1) / g
    if kind == "all-gather":
        return out_bytes * frac
    if kind == "all-reduce":
        return 2.0 * out_bytes * frac
    if kind == "reduce-scatter":
        return out_bytes * g * frac  # operand = g × result
    if kind == "all-to-all":
        return out_bytes * frac
    return out_bytes  # collective-permute


# torch.distributed op (overload packet name) -> HLO collective opcode
_TORCH_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
_TORCH_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor", "c10d")


def collective_kind(func) -> str | None:
    """The HLO collective opcode of a ``torch.distributed`` op, or None."""
    if func.namespace not in _TORCH_NAMESPACES:
        return None
    return _TORCH_KINDS.get(func.overloadpacket.__name__)


def _group_of(args, kwargs) -> int:
    """The size of the process group a functional collective names (its
    ``group_name`` string argument); 2 when none is found, as the
    reference assumes for an unparseable replica group."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return max(int(_resolve_process_group(a).size()), 1)
            except (RuntimeError, ValueError, KeyError):
                continue
        if isinstance(a, dist.ProcessGroup):
            return max(int(a.size()), 1)
    return 2


def collective_stats_from_ops(ops) -> CollectiveStats:
    """Per-device collective bytes of recorded ``torch.distributed`` ops:
    ``ops`` yields ``(func, args, kwargs, out)``, one per op a trace saw;
    ops that are not collectives are skipped."""
    from torch.utils._pytree import tree_flatten

    stats = CollectiveStats()
    for func, args, kwargs, out in ops:
        kind = collective_kind(func)
        if kind is None:
            continue
        outs = [t for t in tree_flatten(out)[0] if hasattr(t, "element_size")]
        out_bytes = float(sum(t.numel() * t.element_size() for t in outs))
        stats.add(kind, ring_bytes(kind, out_bytes, _group_of(args, kwargs or {})))
    return stats
