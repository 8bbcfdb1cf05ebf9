"""Core types of the unified cost engine (port of ``repro/engine/types.py``).

Every consumer that needs to know "what does this configuration cost?"
(admission control, architecture search, benchmarks, serving placement)
expresses the question as a :class:`CostQuery` and receives a
:class:`CostEstimate` — regardless of whether the answer comes from the
fitted perf4sight forest, the analytical closed forms, or the
ground-truth profiler.  Backends implement :class:`CostBackend`; the
batched ``estimate`` signature is the whole point: N candidate queries are
answered with one feature-matrix build + one forest traversal instead of
N scalar round-trips (paper §6.4's 200× search-speed argument, kept honest
at population scale).

Framework-free and held exactly against the reference: ``CostQuery.key``
is the reference's content hash for spec and arch queries, so an estimate
cache written by either package is keyed the same way in the other.  A
model-only query of a CNN departs on purpose: its key marks it as one, so
a measurement is never answered by the cached forest estimate of the spec
query of the same geometry (the reference's keys alias the two).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Protocol, runtime_checkable

from repro_torch.core.features import NetworkSpec

__all__ = [
    "CostQuery",
    "CostEstimate",
    "CostBackend",
    "BackendUnavailable",
    "STAGE_TRAIN",
    "STAGE_INFER",
]

STAGE_TRAIN = "train"
STAGE_INFER = "infer"
_STAGES = (STAGE_TRAIN, STAGE_INFER)


class BackendUnavailable(RuntimeError):
    """Raised by a backend that cannot answer the queries handed to it; the
    ensemble treats it as "fall through to the next backend in the chain"."""


def _geometry(spec: NetworkSpec) -> list[tuple]:
    return [(l.n, l.m, l.k, l.stride, l.padding, l.groups, l.ip) for l in spec.layers]


@dataclass(frozen=True)
class CostQuery:
    """One "what does this cost?" question.

    Exactly one of ``spec`` (a CNN conv-layer topology — the perf4sight
    feature path) or ``arch`` (an LM architecture id from
    ``configs.registry``) identifies the workload.  ``model`` optionally
    carries a concrete built model for the profiler backend; it never
    participates in equality or cache keys.
    """

    bs: int
    stage: str = STAGE_TRAIN
    spec: NetworkSpec | None = None
    arch: str | None = None
    seq: int = 64                      # LM-only: sequence length
    reduced: bool | None = None        # LM-only: smoke-scale config variant;
    #                                    None defers to the backend's default
    model: Any = field(default=None, compare=False, hash=False, repr=False)

    def __post_init__(self):
        if self.stage not in _STAGES:
            raise ValueError(f"stage must be one of {_STAGES}, got {self.stage!r}")
        if self.spec is None and self.arch is None and self.model is None:
            raise ValueError("CostQuery needs a spec, an arch id, or a model")

    @property
    def key(self) -> str:
        """Content key: stable across processes, independent of spec naming
        (two specs with identical layer geometry share estimates)."""
        extra = {}
        if self.spec is not None:
            ident = _geometry(self.spec)
        elif self.arch is not None:
            ident = self.arch
        else:
            # model-only query: name alone collides across pruned variants
            # of one family — key on the conv geometry when available.
            conv_specs = getattr(self.model, "conv_specs", None)
            if callable(conv_specs):
                ident = _geometry(conv_specs())
                # Departs from the reference's key on purpose: a model-only
                # query asks for a measurement (only the profiler answers
                # it), so it must not share an entry with the spec query of
                # the same geometry, which a forest answers.
                extra = {"model": True}
            else:
                ident = [getattr(self.model, "name", repr(type(self.model))),
                         sorted(getattr(self.model, "widths", {}).items())]
        blob = json.dumps(
            {"id": ident, "bs": self.bs, "stage": self.stage,
             "seq": self.seq if self.arch is not None else None,
             "reduced": self.reduced if self.arch is not None else None, **extra},
            sort_keys=True,
        )
        return hashlib.sha1(blob.encode()).hexdigest()


@dataclass
class CostEstimate:
    """Predicted (Γ memory, Φ latency, E energy) for one query, tagged with
    the backend that produced it.

    ``energy_j`` is the predicted per-step energy in joules — 0.0 when the
    answering backend has no power model (zero-watt device envelope, forest
    without an energy fit).  Per-class attribution rides in
    ``detail["energy_classes"]`` when the analytical path answered."""

    gamma_mb: float
    phi_ms: float
    energy_j: float = 0.0
    source: str = ""
    detail: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"gamma_mb": self.gamma_mb, "phi_ms": self.phi_ms,
                "energy_j": self.energy_j,
                "source": self.source, "detail": self.detail}

    @classmethod
    def from_dict(cls, d: dict) -> "CostEstimate":
        # .get: estimate caches written before the energy attribute load
        # with energy defaulted, not invalidated.
        return cls(gamma_mb=float(d["gamma_mb"]), phi_ms=float(d["phi_ms"]),
                   energy_j=float(d.get("energy_j", 0.0)),
                   source=d.get("source", ""), detail=d.get("detail", {}))


@runtime_checkable
class CostBackend(Protocol):
    """The uniform prediction interface.

    ``supports`` is a cheap per-query capability check (no computation);
    ``estimate`` answers a *batch* of supported queries in one call and
    must return one estimate per query, in order.  A backend that cannot
    answer (not fitted, missing dependency, no card) raises
    :class:`BackendUnavailable` for the whole batch.
    """

    name: str

    def supports(self, query: CostQuery) -> bool: ...

    def estimate(self, queries: list[CostQuery]) -> list[CostEstimate]: ...
