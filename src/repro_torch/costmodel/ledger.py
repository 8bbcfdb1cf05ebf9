"""The per-op cost record (port of ``repro/costmodel/ledger.py``).

This slice ports what the kernel autotuner needs: :class:`OpCost` (which
``kernels.autotune.KernelCost`` extends), the closed op-class vocabulary
:data:`OP_CLASSES` and :func:`classify_op`.  ``CostLedger``, the ordered
container that the HLO parse fills in the reference, comes with the
cost-ledger producer (ROADMAP queue 1, item 5b).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

__all__ = ["OP_CLASSES", "OpCost", "classify_op"]

# Closed vocabulary, most-structured first.  "matmul" and "conv" carry the
# FMA work; "collective" the inter-device traffic; "reduction" the
# tree-shaped ops; "data_movement" pure layout/copy traffic; "elementwise"
# the fused pointwise bulk; "other" anything opaque (custom calls).
OP_CLASSES: tuple[str, ...] = (
    "matmul", "conv", "collective", "reduction", "data_movement",
    "elementwise", "other",
)

_COLLECTIVE_OPS = {
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
}
_REDUCTION_OPS = {"reduce", "reduce-window", "sort", "select-and-scatter"}
_DATA_MOVEMENT_OPS = {
    "copy", "copy-start", "copy-done", "transpose", "broadcast", "reshape",
    "slice", "dynamic-slice", "dynamic-update-slice", "gather", "scatter",
    "concatenate", "pad", "reverse", "iota",
}
_OPAQUE_OPS = {"custom-call", "infeed", "outfeed", "rng", "rng-bit-generator"}


def classify_op(opcode: str, *, dot_flops: float = 0.0,
                conv_flops: float = 0.0) -> str:
    """Map an (HLO-named) opcode to its :data:`OP_CLASSES` entry.

    ``dot_flops``/``conv_flops`` let a wrapper op that *contains*
    contraction work classify as the work it feeds.  Both async halves
    (``*-start``/``*-done``) classify together."""
    base = opcode.replace("-start", "").replace("-done", "")
    if base in _COLLECTIVE_OPS:
        return "collective"
    if base == "dot" or (dot_flops > 0 and dot_flops >= conv_flops):
        return "matmul"
    if base == "convolution" or conv_flops > 0:
        return "conv"
    if base in _REDUCTION_OPS:
        return "reduction"
    if base in _DATA_MOVEMENT_OPS:
        return "data_movement"
    if base in _OPAQUE_OPS or not base:
        return "other"
    return "elementwise"


@dataclass(frozen=True, kw_only=True)
class OpCost:
    """Cost of one op or one kernel launch.

    Keyword-only, with a default for every field, so that a positional call
    cannot bind costs to the wrong slots (subclasses inherit that).
    ``flops``/``hbm_bytes``/``collective_bytes`` are effective totals with
    ``trip_multiplier`` already applied; ``energy_j`` is dynamic energy
    (zero until a device prices it); ``vmem_bytes`` is the on-chip working
    set that a tiling model reports; ``origin`` names the computation or
    kernel; ``count`` supports merged group records."""

    op: str = ""
    op_class: str = "other"
    dtype: str = ""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    energy_j: float = 0.0
    vmem_bytes: float = 0.0
    trip_multiplier: float = 1.0
    origin: str = ""
    count: int = 1

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "OpCost":
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})
