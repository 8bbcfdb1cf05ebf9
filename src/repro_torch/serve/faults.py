"""Deterministic fault injection for the serve stack (see docs/serve.md
"Failure semantics").

Robustness claims are only testable if the failures are reproducible: a
:class:`FaultPlan` is a *schedule* of faults pinned to engine step
indices, built either explicitly (unit tests plant one fault at one
step) or from a seeded RNG (:meth:`FaultPlan.seeded` — the chaos bench
replays the identical fault sequence on every run).  The engine drives
the plan's step cursor (``begin_step``); the injection sites *consult*
it (``fire``), so production code paths and fault paths are the same
code — a fired fault is indistinguishable from the real failure it
models:

* ``"alloc"``  — :meth:`PagedKVCache.alloc` returns ``None`` as if the
  pool had no free blocks (→ admission retry / decode-time preemption);
* ``"backend"`` — the admission failover chain raises
  :class:`FaultInjected` in place of the backend call (→ health
  step-down forest → analytical → static degraded mode);
* ``"slow"``   — the engine's virtual clock skews forward by the
  fault's ``delay_s`` as if the step had stalled (→ deadline expiry and
  watchdog paths, without real sleeps in tests).

A plan is single-use state: it counts what actually fired
(:attr:`fired`) so tests and the chaos bench can assert the faults they
planned really happened instead of silently missing the window.

Port of ``repro/serve/faults.py`` (numpy only, unchanged).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Fault", "FaultInjected", "FaultPlan", "FAULT_KINDS"]

FAULT_KINDS = ("alloc", "backend", "slow")


class FaultInjected(RuntimeError):
    """The synthetic backend exception a ``"backend"`` fault raises —
    typed so tests can tell an injected failure from a real bug."""


@dataclass(frozen=True)
class Fault:
    """One planned fault: ``kind`` fires at engine step ``step``.

    ``count`` is how many injection-site consultations it poisons within
    that step (an ``"alloc"`` fault with count=2 fails two consecutive
    allocation attempts); ``delay_s`` is the virtual stall a ``"slow"``
    fault adds to the engine clock."""

    step: int
    kind: str
    count: int = 1
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if self.step < 0 or self.count < 1 or self.delay_s < 0:
            raise ValueError(f"invalid fault {self!r}")


class FaultPlan:
    def __init__(self, faults: "list[Fault] | tuple[Fault, ...]" = ()):
        self.faults = sorted(faults, key=lambda f: (f.step, f.kind))
        self._by_step: dict[int, list[Fault]] = {}
        for f in self.faults:
            self._by_step.setdefault(f.step, []).append(f)
        self.fired = {k: 0 for k in FAULT_KINDS}
        self._step: int | None = None
        self._budget: dict[str, int] = {}
        self._slow_pending = 0.0

    @classmethod
    def seeded(cls, seed: int, *, n_steps: int, p_alloc: float = 0.0,
               p_backend: float = 0.0, p_slow: float = 0.0,
               slow_s: float = 0.05) -> "FaultPlan":
        """Bernoulli-per-step plan from one RNG seed: the same seed
        always builds the same schedule (the chaos bench's contract)."""
        rng = np.random.default_rng(seed)
        faults = []
        for step in range(n_steps):
            if p_alloc and rng.random() < p_alloc:
                faults.append(Fault(step, "alloc"))
            if p_backend and rng.random() < p_backend:
                faults.append(Fault(step, "backend"))
            if p_slow and rng.random() < p_slow:
                faults.append(Fault(step, "slow", delay_s=slow_s))
        return cls(faults)

    # ------------------------------------------------------------------

    def begin_step(self, step: int) -> None:
        """Advance the cursor: subsequent ``fire`` calls consult the
        faults planned for ``step``.  Un-fired budget from the previous
        step is dropped (a fault that found no injection site in its
        step never fired — ``summary`` shows the shortfall)."""
        self._step = int(step)
        self._budget = {}
        self._slow_pending = 0.0
        for f in self._by_step.get(self._step, ()):
            if f.kind == "slow":
                self._slow_pending += f.delay_s
            else:
                self._budget[f.kind] = self._budget.get(f.kind, 0) + f.count

    def fire(self, kind: str) -> float:
        """Consume one planned fault of ``kind`` at the current step.

        Returns a truthy payload when a fault fires — ``1`` for
        alloc/backend, the stall seconds for ``"slow"`` — and ``0``
        otherwise (including before any ``begin_step``)."""
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        if self._step is None:
            return 0
        if kind == "slow":
            delay, self._slow_pending = self._slow_pending, 0.0
            if delay > 0:
                self.fired["slow"] += 1
            return delay
        if self._budget.get(kind, 0) > 0:
            self._budget[kind] -= 1
            self.fired[kind] += 1
            return 1
        return 0

    # ------------------------------------------------------------------

    @property
    def planned(self) -> dict:
        out = {k: 0 for k in FAULT_KINDS}
        for f in self.faults:
            out[f.kind] += 1 if f.kind == "slow" else f.count
        return out

    def summary(self) -> dict:
        """Planned vs actually-fired counts, per kind."""
        return {"planned": self.planned, "fired": dict(self.fired)}
