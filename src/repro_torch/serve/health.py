"""Backend failover for the serve admission path (port of
``repro/serve/health.py``; framework-free, held exactly).

The ``SLOScheduler`` prices every admission through a ``CostEngine``
whose backend is conventionally an ``EnsembleBackend`` chain
(forest → analytical).  The chain already degrades on the *semantic*
failure (:class:`~repro_torch.engine.types.BackendUnavailable` = "I
cannot score this"); a backend that *crashes* — a real exception from a
poisoned forest file, a failed trace, an injected fault — is a handled
event here:

* the ensemble chain is unrolled into per-suffix sub-engines (level 0 =
  the full chain, level 1 = chain minus its head, …) sharing the
  original engine's estimate cache and device salt;
* a :class:`~repro_torch.engine.engine.HealthState` tracks the trusted
  level: repeated exceptions step it down (forest → analytical →
  ``static``), and a periodic probe steps it back up once the better
  level answers again;
* the floor is **static degraded mode**: ``estimate_one`` returns
  ``None`` and the scheduler falls back to a conservative static slot
  budget (serve fewer, but keep serving);
* ``BackendUnavailable`` still propagates unchanged (it is an answer,
  not a failure), so un-scorable arches keep their ungated path.

A :class:`~repro_torch.serve.faults.FaultPlan` injects ``"backend"``
faults here — the injected exception takes the exact path a real one
would.
"""

from __future__ import annotations

from repro_torch.engine.engine import CostEngine, HealthState
from repro_torch.engine.types import BackendUnavailable
from repro_torch.serve.faults import FaultInjected

__all__ = ["FailoverChain", "STATIC_LEVEL"]

STATIC_LEVEL = "static"


class FailoverChain:
    def __init__(self, engine: CostEngine, *, fail_threshold: int = 3,
                 probe_every: int = 8, faults=None,
                 health: HealthState | None = None):
        from repro_torch.engine.backends import EnsembleBackend

        self.engine = engine
        # Duck-typed engines (test stubs, custom scorers) may not expose a
        # ``backend`` chain — they become a single-level chain whose only
        # fallback is the static floor.
        backend = getattr(engine, "backend", None)
        chain = (list(backend.backends)
                 if isinstance(backend, EnsembleBackend)
                 else [backend if backend is not None else engine])
        names = [getattr(b, "name", type(b).__name__) for b in chain]
        # Level i answers through the chain suffix chain[i:].  Level 0 is
        # the caller's engine itself (its cache hit/miss counters keep
        # meaning what they meant); deeper levels share the same cache
        # object — estimate keys are salted per backend chain, so a
        # level-1 answer never aliases a level-0 one.
        self.engines: list[CostEngine] = [engine]
        for i in range(1, len(chain)):
            sub = chain[i] if i == len(chain) - 1 else EnsembleBackend(chain[i:])
            self.engines.append(CostEngine(sub, cache=engine.cache,
                                           device=engine.device))
        self.health = health or HealthState(
            names + [STATIC_LEVEL], fail_threshold=fail_threshold,
            probe_every=probe_every)
        if len(self.health.levels) != len(self.engines) + 1:
            raise ValueError("health chain does not match backend chain")
        self.faults = faults

    @property
    def degraded(self) -> bool:
        return self.health.degraded

    def estimate_one(self, query):
        """One estimate through the healthiest level that answers.

        Returns the estimate, or ``None`` when every model-backed level
        failed (or the chain is pinned at the static floor) — the
        caller's signal to apply its static degraded policy.  Raises
        only ``BackendUnavailable`` (semantic, health-neutral); any
        other backend exception is recorded against the health state and
        absorbed by falling down the chain.
        """
        h = self.health
        probe = h.probe_level()
        start = probe if probe is not None else h.level
        poisoned = int(self.faults.fire("backend")) if self.faults else 0
        for lvl in range(start, len(self.engines)):
            try:
                if poisoned > 0:
                    poisoned -= 1
                    raise FaultInjected(
                        f"injected backend fault at {h.levels[lvl]}")
                est = self.engines[lvl].estimate_one(query)
            except BackendUnavailable:
                raise
            except Exception as e:
                # Failed probes don't count against the trusted level —
                # only failures at (or below) it advance the step-down.
                if lvl >= h.level:
                    h.record_failure(e)
                continue
            h.record_success(lvl)
            return est
        return None

    def metrics(self) -> dict:
        return self.health.metrics()
