"""The per-op cost IR (port of ``repro/costmodel/ledger.py``).

Every cost producer emits the same record, :class:`OpCost` — the aten-op
trace of ``core/hlo_cost.trace_cost`` and the kernel tiling models
(``kernels.autotune.KernelCost`` extends it) — and every consumer reads
it: calibration columns, roofline breakdowns, serve refusals, the tuner's
ranking.  Contracts, as in the reference:

* **Parity** — summing a ledger's records left to right reproduces the
  aggregates exactly (``CostLedger.flops`` et al. are how
  ``trace_cost`` computes its scalars).
* **Taxonomy** — :data:`OP_CLASSES` is the closed op-class vocabulary;
  :func:`classify_op` maps an (HLO-named) opcode to a class.
* **Persistence** — NPZ (packed columns) or JSON, chosen by extension,
  written atomically through ``core/fileio``, in the reference's layout:
  a ledger saved by either package loads in the other.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, replace

__all__ = ["OP_CLASSES", "OpCost", "CostLedger", "classify_op"]

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


# Numeric NPZ columns (strings ride in the JSON header).  ``energy_j``
# is last so pre-energy NPZ files load with the column defaulted.
_NUM_COLS = ("flops", "hbm_bytes", "collective_bytes", "vmem_bytes",
             "trip_multiplier", "count", "energy_j")
_STR_COLS = ("op", "op_class", "dtype", "origin")

# One class bucket — what class_sums/merge_class_sums accumulate.
_ZERO_BUCKET = {"flops": 0.0, "hbm_bytes": 0.0, "collective_bytes": 0.0,
                "energy_j": 0.0, "count": 0}


def _empty_class_sums() -> dict[str, dict]:
    return {cls: dict(_ZERO_BUCKET) for cls in OP_CLASSES}


def _drop_zero_classes(sums: dict[str, dict]) -> dict[str, dict]:
    return {cls: s for cls, s in sums.items() if any(s.values())}


class CostLedger:
    """Ordered container of :class:`OpCost` records with groupby views.

    Aggregates (``flops``, ``hbm_bytes``, ``collective_bytes``,
    ``energy_j``) are plain left-to-right sums over the records — the
    parity contract with the producer's scalar totals.  ``class_sums`` /
    ``top_k`` are the attribution views every consumer shares."""

    def __init__(self, records: "list[OpCost] | None" = None):
        self.records: list[OpCost] = list(records) if records else []

    # -- building ----------------------------------------------------------

    def append(self, record: OpCost) -> None:
        self.records.append(record)

    def extend(self, records) -> None:
        self.records.extend(records)

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)

    def __eq__(self, other) -> bool:
        return isinstance(other, CostLedger) and self.records == other.records

    # -- aggregates (the parity contract) ----------------------------------

    def _total(self, attr: str) -> float:
        total = 0.0
        for r in self.records:
            total += getattr(r, attr)
        return total

    @property
    def flops(self) -> float:
        return self._total("flops")

    @property
    def hbm_bytes(self) -> float:
        return self._total("hbm_bytes")

    @property
    def collective_bytes(self) -> float:
        return self._total("collective_bytes")

    @property
    def energy_j(self) -> float:
        return self._total("energy_j")

    def totals(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes,
                "energy_j": self.energy_j}

    # -- attribution views --------------------------------------------------

    def class_sums(self, *, keep_zero: bool = False) -> dict[str, dict]:
        """Per-class aggregate: ``{cls: {flops, hbm_bytes, collective_bytes,
        energy_j, count}}`` in :data:`OP_CLASSES` order (zero classes
        dropped unless ``keep_zero``)."""
        sums = _empty_class_sums()
        for r in self.records:
            s = sums.setdefault(r.op_class, dict(_ZERO_BUCKET))
            s["flops"] += r.flops
            s["hbm_bytes"] += r.hbm_bytes
            s["collective_bytes"] += r.collective_bytes
            s["energy_j"] += r.energy_j
            s["count"] += r.count
        return sums if keep_zero else _drop_zero_classes(sums)

    @staticmethod
    def merge_class_sums(sums_list, *, keep_zero: bool = False
                         ) -> dict[str, dict]:
        """Merge many ``class_sums()``-shaped dicts into one, with the same
        bucket fields and zero-class filter as :meth:`class_sums`."""
        merged = _empty_class_sums()
        for sums in sums_list:
            for cls, s in (sums or {}).items():
                t = merged.setdefault(cls, dict(_ZERO_BUCKET))
                for k in _ZERO_BUCKET:
                    t[k] += s.get(k, 0)
        return merged if keep_zero else _drop_zero_classes(merged)

    def top_k(self, k: int = 5, by: str = "hbm_bytes") -> list[OpCost]:
        """The ``k`` most expensive records by one attribute."""
        if by not in OpCost.__dataclass_fields__:
            raise KeyError(f"unknown OpCost attribute {by!r}")
        return sorted(self.records, key=lambda r: getattr(r, by),
                      reverse=True)[:k]

    def scaled(self, mult: float) -> "CostLedger":
        """A copy with every record's effective totals × ``mult``."""
        return CostLedger([
            replace(r, flops=r.flops * mult, hbm_bytes=r.hbm_bytes * mult,
                    collective_bytes=r.collective_bytes * mult,
                    energy_j=r.energy_j * mult)
            for r in self.records
        ])

    # -- persistence (core/fileio contract) ---------------------------------

    def to_json_dict(self) -> dict:
        return {"schema": 1, "records": [r.to_dict() for r in self.records]}

    @classmethod
    def from_json_dict(cls, d: dict) -> "CostLedger":
        return cls([OpCost.from_dict(r) for r in d.get("records", [])])

    def save(self, path: str) -> None:
        """Atomic persist: ``.npz`` packs numeric columns (+ a JSON header
        for the string columns), anything else writes inspectable JSON."""
        from repro_torch.core.fileio import atomic_write_bytes, atomic_write_json

        if path.endswith(".npz"):
            import numpy as np

            arrays = {
                col: np.asarray([getattr(r, col) for r in self.records],
                                dtype=np.int64 if col == "count"
                                else np.float64)
                for col in _NUM_COLS
            }
            header = json.dumps({
                col: [getattr(r, col) for r in self.records]
                for col in _STR_COLS
            })
            arrays["ledger_header"] = np.frombuffer(header.encode(),
                                                    dtype=np.uint8)
            atomic_write_bytes(path, lambda f: np.savez_compressed(f, **arrays),
                               suffix=".npz")
            return
        atomic_write_json(path, self.to_json_dict())

    @classmethod
    def load(cls, path: str) -> "CostLedger":
        if path.endswith(".npz"):
            import numpy as np

            with np.load(path) as z:
                header = json.loads(bytes(z["ledger_header"].tobytes()).decode())
                n = len(header[_STR_COLS[0]]) if header[_STR_COLS[0]] else \
                    int(z[_NUM_COLS[0]].shape[0])
                cols = {c: z[c] for c in _NUM_COLS if c in z}
                return cls([
                    OpCost(
                        op=header["op"][i], op_class=header["op_class"][i],
                        dtype=header["dtype"][i], origin=header["origin"][i],
                        flops=float(cols["flops"][i]),
                        hbm_bytes=float(cols["hbm_bytes"][i]),
                        collective_bytes=float(cols["collective_bytes"][i]),
                        energy_j=float(cols["energy_j"][i])
                        if "energy_j" in cols else 0.0,
                        vmem_bytes=float(cols["vmem_bytes"][i]),
                        trip_multiplier=float(cols["trip_multiplier"][i]),
                        count=int(cols["count"][i]),
                    )
                    for i in range(n)
                ])
        with open(path) as f:
            return cls.from_json_dict(json.load(f))
