"""The cost engine: one batched, cacheable prediction front door (port of
``repro/engine/engine.py``; framework-free and held exactly: the salted
cache keys, hits, misses, flushes and ``HealthState`` metrics are the
reference's).

``CostEngine`` wraps any :class:`CostBackend` (usually an
:class:`~repro_torch.engine.backends.EnsembleBackend` chain) with a content-keyed
on-disk estimate cache and an admission helper.  Consumers — the
evolutionary search, the training launcher, benchmarks — talk only to this
class; which backend answered, and whether it came from cache, is carried
in each estimate's ``source`` / ``detail``.
"""

from __future__ import annotations

import hashlib

from repro_torch.engine.cache import EstimateCache
from repro_torch.engine.devices import resolve_device
from repro_torch.engine.types import CostBackend, CostEstimate, CostQuery

__all__ = ["CostEngine", "HealthState"]


class HealthState:
    """Consecutive-failure state machine over a named failover chain.

    The cost engine's backends are *predictors* — when one starts
    throwing real exceptions (not the semantic
    :class:`~repro_torch.engine.types.BackendUnavailable`), the consumer
    should stop asking it, not crash.  ``HealthState`` tracks which link
    of a chain (e.g. ``["forest", "analytical", "static"]``) is
    currently trusted:

    * :meth:`record_failure` at the trusted level steps down one level
      after ``fail_threshold`` *consecutive* failures (the last level —
      conventionally a model-free ``"static"`` degraded mode — is the
      floor: it cannot fail, so the chain never runs out of answers);
    * :meth:`record_success` resets the consecutive counter, and — when
      the success came from a *better* level than the trusted one (a
      probe) — recovers the trusted level upward;
    * :meth:`probe_level` schedules recovery: every ``probe_every``
      calls while degraded, one call is routed through the next-better
      level to test whether it healed.

    The serve failover chain (``serve.health.FailoverChain``, in the
    reference and in the port) drives this; :meth:`metrics` is
    what the engine surfaces per step so benches and tests assert on
    failovers/recoveries instead of log-scraping.
    """

    def __init__(self, levels: "list[str] | tuple[str, ...]", *,
                 fail_threshold: int = 3, probe_every: int = 8):
        if not levels:
            raise ValueError("empty health chain")
        self.levels = [str(x) for x in levels]
        self.fail_threshold = max(1, int(fail_threshold))
        self.probe_every = max(1, int(probe_every))
        self.level = 0
        self.consecutive = 0
        self.calls = 0
        self.failovers = 0
        self.recoveries = 0
        self.probes = 0
        self.last_error: str | None = None

    @property
    def current(self) -> str:
        return self.levels[self.level]

    @property
    def degraded(self) -> bool:
        """At the chain floor (no model-backed level left)."""
        return len(self.levels) > 1 and self.level == len(self.levels) - 1

    def record_success(self, level: int | None = None) -> None:
        if level is not None and level < self.level:
            self.level = level           # successful probe: recover
            self.recoveries += 1
        if level is None or level <= self.level:
            # A success at a *worse* level than the trusted one doesn't
            # reset the count — the trusted level is still failing, and
            # absolving it here would keep every call paying its crash.
            self.consecutive = 0

    def record_failure(self, err: "BaseException | str | None" = None) -> bool:
        """Count one failure at the trusted level; returns True when it
        tripped a step-down."""
        if err is not None:
            self.last_error = (f"{type(err).__name__}: {err}"
                               if isinstance(err, BaseException) else str(err))
        self.consecutive += 1
        if (self.consecutive >= self.fail_threshold
                and self.level < len(self.levels) - 1):
            self.level += 1
            self.consecutive = 0
            self.failovers += 1
            return True
        return False

    def probe_level(self) -> int | None:
        """Level to try this call instead of the trusted one, or None.
        Advances the call counter; while degraded below level 0, every
        ``probe_every``-th call probes one level up."""
        self.calls += 1
        if self.level > 0 and self.calls % self.probe_every == 0:
            self.probes += 1
            return self.level - 1
        return None

    def metrics(self) -> dict:
        return {
            "level": self.level,
            "current": self.current,
            "degraded": self.degraded,
            "failovers": self.failovers,
            "recoveries": self.recoveries,
            "probes": self.probes,
            "consecutive_failures": self.consecutive,
            "last_error": self.last_error,
        }


class CostEngine:
    """Cache-first front door over a backend.

    Cache keys are the query's content hash salted with the backend's
    ``cache_salt()`` (fitted-model content hash, hardware table, reduced
    flag, …), so estimates from a refit predictor or a different backend
    configuration never alias on disk.

    ``flush_every`` amortizes disk writes: the JSON cache is rewritten
    atomically once at least that many new estimates have accumulated
    (and always at the end of the ``estimate`` call that crossed the
    threshold).  The default of 1 flushes after every miss batch —
    maximum durability; raise it for cheap-to-recompute backends in hot
    search loops and call :meth:`flush` at the end.
    """

    def __init__(self, backend: CostBackend, cache: EstimateCache | str | None = None,
                 *, flush_every: int = 1, device=None):
        self.backend = backend
        self.cache = EstimateCache(cache) if isinstance(cache, str) else cache
        self.flush_every = max(1, int(flush_every))
        # Optional engine-level device: an extra salt over the backend's own
        # (so two engines serving different devices through one device-less
        # backend never alias), and the default admission capacity.
        self.device = resolve_device(device) if device is not None else None
        self.hits = 0
        self.misses = 0
        self._pending = 0

    def _salt(self) -> str:
        # Recomputed per batch, NOT memoized: a refit predictor must change
        # the salt (the expensive part — the forest content hash — is
        # memoized per packing on the forest itself).
        salt_fn = getattr(self.backend, "cache_salt", None)
        salt = salt_fn() if callable(salt_fn) else self.backend.name
        if self.device is not None:
            salt = f"{salt}@{self.device.fingerprint()}"
        return salt

    def estimate(self, queries: list[CostQuery]) -> list[CostEstimate]:
        """Answer a batch of queries: cache first, then ONE batched backend
        call for all misses, then (at most) a single atomic cache flush."""
        results: list[CostEstimate | None] = [None] * len(queries)
        miss_idx: list[int] = []
        if self.cache is not None:
            salt = self._salt()
            keys = [
                hashlib.sha1(f"{q.key}|{salt}".encode()).hexdigest()
                for q in queries
            ]
        else:
            keys = None
        for i, q in enumerate(queries):
            cached = self.cache.get(keys[i]) if keys is not None else None
            if cached is not None:
                cached.detail = dict(cached.detail, cached=True)
                results[i] = cached
                self.hits += 1
            else:
                miss_idx.append(i)
        if miss_idx:
            self.misses += len(miss_idx)
            fresh = self.backend.estimate([queries[i] for i in miss_idx])
            for i, est in zip(miss_idx, fresh):
                results[i] = est
                if keys is not None:
                    self.cache.put(keys[i], est)
            if self.cache is not None:
                self._pending += len(miss_idx)
                if self._pending >= self.flush_every:
                    self.flush()
        return results

    def flush(self) -> None:
        if self.cache is not None and self._pending:
            self.cache.flush()
            self._pending = 0

    def estimate_one(self, query: CostQuery) -> CostEstimate:
        return self.estimate([query])[0]

    def estimate_requests(
        self,
        arch: str,
        lens: list[int],
        *,
        stage: str = "infer",
        reduced: bool = False,
        bs: int = 1,
        bucket: int = 64,
    ) -> list[CostEstimate]:
        """One estimate per serving request, bucketed to stay cacheable.

        Ragged request lengths would make every admission a distinct
        query; rounding each length up to a ``bucket`` multiple collapses
        them onto a handful of (bs, seq) cells, so a serving scheduler
        pricing thousands of arrivals issues (and caches) only as many
        backend calls as there are occupied buckets.  Estimates fan back
        out in request order.
        """
        bucket = max(1, int(bucket))
        seqs = [max(bucket, -(-int(L) // bucket) * bucket) for L in lens]
        uniq = sorted(set(seqs))
        ests = self.estimate([
            CostQuery(arch=arch, bs=bs, seq=s, stage=stage, reduced=reduced)
            for s in uniq
        ])
        by_seq = dict(zip(uniq, ests))
        return [by_seq[s] for s in seqs]

    def admit(
        self,
        query: CostQuery,
        *,
        gamma_budget_mb: float | None = None,
        phi_budget_ms: float | None = None,
        energy_budget_j: float | None = None,
        safety_margin: float = 0.1,
    ) -> tuple[bool, dict]:
        """Admission gate (paper §6.4 safety property), backend-agnostic:
        refuse when the predicted footprint/latency/step-energy, inflated
        by ``safety_margin``, exceeds the budget.  With an engine-level
        device and no explicit memory budget, the device's capacity is the
        budget.
        """
        if gamma_budget_mb is None and self.device is not None:
            gamma_budget_mb = self.device.hbm_bytes / 1e6
        est = self.estimate_one(query)
        g_eff = est.gamma_mb * (1 + safety_margin)
        p_eff = est.phi_ms * (1 + safety_margin)
        e_eff = est.energy_j * (1 + safety_margin)
        ok = not (
            (gamma_budget_mb is not None and g_eff > gamma_budget_mb)
            or (phi_budget_ms is not None and p_eff > phi_budget_ms)
            or (energy_budget_j is not None and e_eff > energy_budget_j)
        )
        return ok, {"gamma_mb": est.gamma_mb, "phi_ms": est.phi_ms,
                    "energy_j": est.energy_j,
                    "gamma_eff": g_eff, "phi_eff": p_eff,
                    "energy_eff": e_eff, "source": est.source}
