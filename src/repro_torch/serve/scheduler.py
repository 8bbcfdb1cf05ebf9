"""SLO-aware admission scheduler: price the batch before joining it (port
of ``repro/serve/scheduler.py``; framework-free, held exactly).

perf4sight's predict-then-place property, applied per request: before a
prompt may occupy a decode slot, the scheduler prices the batch as it
would look *after* admission (one ``CostQuery`` at ``bs = running + 1``
over the full context window) through a ``CostEngine`` chain, and
compares:

* predicted memory footprint (× safety margin) against the
  ``DeviceSpec`` HBM envelope / explicit ``gamma_budget_mb``;
* predicted step energy (× safety margin) against an explicit
  ``energy_budget_j`` power/thermal envelope;
* a per-token latency proxy (``phi_ms / max_len`` of the composed
  batch) against the request's latency SLO;
* a time-to-first-token proxy (the request's own prefill priced at
  ``bs=1`` over its prompt) against ``ServeSLO.ttft_ms``;
* the request's own token need against the context window.

Decisions are ``ADMIT`` (join now), ``DEFER``, or ``REFUSE``, split by
*whose fault the failure is*: a batch-dependent miss that clears when the
request is re-priced alone at ``bs=1`` is occupancy-transient (``DEFER``,
the engine retries with backoff); a miss that persists even alone (or a
TTFT/context-window miss) is ``REFUSE`` — a :class:`PlacementRefused`
carrying the estimate's ledger-class breakdown (``cost_classes``, and
``energy_classes`` when energy was priced).

With a fitted LM forest behind the engine the decision path traces
nothing; with the port's ``AnalyticalBackend`` each new (bs, seq) key
costs one meta-tensor trace of the step (no launch, no allocation) and a
repeated key none.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig

__all__ = ["Decision", "PlacementRefused", "SLOScheduler", "ServeSLO"]


class PlacementRefused(RuntimeError):
    """The admission gate predicted this placement exceeds the device.

    ``info`` carries the gate's evidence: predicted vs effective footprint,
    budget, backend source, and (when the analytical backend answered) the
    per-ledger-class cost breakdown.
    """

    def __init__(self, message: str, info: dict | None = None):
        super().__init__(message)
        self.info = info or {}


class Decision(enum.Enum):
    ADMIT = "admit"
    DEFER = "defer"
    REFUSE = "refuse"


@dataclass
class ServeSLO:
    """Serving-cell service-level objectives (engine-wide defaults;
    ``Request.slo_ms`` overrides per request)."""
    ttft_ms: float | None = None   # first-token target, prefill proxy
    tpot_ms: float | None = None   # per-output-token target, decode proxy


class SLOScheduler:
    def __init__(self, cfg: ArchConfig, cost_engine, *,
                 max_len: int, n_slots: int,
                 gamma_budget_mb: float | None = None,
                 energy_budget_j: float | None = None,
                 safety_margin: float = 0.1,
                 slo: ServeSLO | None = None,
                 seq_bucket: int = 64,
                 failover=None,
                 degraded_slots: int | None = None):
        self.cfg = cfg
        self.engine = cost_engine
        self.max_len = int(max_len)
        self.n_slots = int(n_slots)
        self.safety_margin = float(safety_margin)
        self.slo = slo or ServeSLO()
        self.seq_bucket = max(1, int(seq_bucket))
        # Failover chain (serve/health.py): backend *crashes* are health
        # events, not admission answers.  When every model-backed level
        # is down the scheduler falls back to a conservative static slot
        # budget — serve fewer, but keep serving.
        self.failover = failover
        self.degraded_slots = (max(1, int(degraded_slots))
                               if degraded_slots is not None
                               else max(1, self.n_slots // 2))
        # Registry convention: ArchConfig.reduced() appends "-smoke"; the
        # gate must predict the config actually being served.
        arch, reduced = cfg.name, False
        if arch.endswith("-smoke"):
            arch, reduced = arch[: -len("-smoke")], True
        self.arch, self.reduced = arch, reduced
        budget = gamma_budget_mb
        device = getattr(cost_engine, "device", None)
        if budget is None and device is not None:
            budget = device.hbm_bytes / 1e6
        self.gamma_budget_mb = budget
        self.energy_budget_j = energy_budget_j
        self.device = device
        self.unavailable: str | None = None   # backend couldn't score us
        self._last_miss: str | None = None    # why the last estimate was None

    # ------------------------------------------------------------------

    def _estimate(self, bs: int, seq: int):
        from repro_torch.engine import BackendUnavailable, CostQuery

        seq = min(self.max_len,
                  max(self.seq_bucket,
                      -(-seq // self.seq_bucket) * self.seq_bucket))
        query = CostQuery(arch=self.arch, bs=max(1, bs), seq=seq,
                          stage="infer", reduced=self.reduced)
        self._last_miss = None
        try:
            if self.failover is not None:
                # None here means "every model-backed level failed" —
                # the degraded-mode signal, distinct from the semantic
                # BackendUnavailable (which still raises through).
                est = self.failover.estimate_one(query)
                if est is None:
                    self._last_miss = "degraded"
                return est
            return self.engine.estimate_one(query)
        except BackendUnavailable as e:
            self.unavailable = str(e)
            self._last_miss = "unavailable"
            return None

    def price(self, request) -> "object | None":
        """Per-request cost (bs=1 over its own token need) — attached to
        the request for the bench's goodput accounting."""
        est = self._estimate(1, request.prompt_len + request.max_new_tokens)
        request.estimate = est
        return est

    # ------------------------------------------------------------------

    def _gate_info(self, est, bs: int) -> dict:
        """The gate's evidence for one priced batch composition."""
        margin = 1 + self.safety_margin
        info = {
            "bs": bs, "seq": self.max_len,
            "gamma_mb": est.gamma_mb, "gamma_eff": est.gamma_mb * margin,
            "phi_ms": est.phi_ms, "source": est.source,
            "budget_mb": self.gamma_budget_mb,
        }
        if self.energy_budget_j is not None or est.energy_j:
            info["energy_j"] = est.energy_j
            info["energy_eff"] = est.energy_j * margin
            info["energy_budget_j"] = self.energy_budget_j
        if self.device is not None:
            info["device"] = self.device.name
        detail = est.detail or {}
        if detail.get("cost_classes") is not None:
            info["cost_classes"] = detail["cost_classes"]
        if detail.get("energy_classes") is not None:
            info["energy_classes"] = detail["energy_classes"]
        return info

    def _batch_reason(self, est, request, bs: int, info: dict) -> str | None:
        """First batch-dependent gate the composed batch fails (None = all
        pass).  These are the checks that can clear at lower occupancy —
        the DEFER candidates; occupancy-independent gates (context window,
        TTFT) live in :meth:`admit` directly."""
        margin = 1 + self.safety_margin
        if (self.gamma_budget_mb is not None
                and est.gamma_mb * margin > self.gamma_budget_mb):
            return (f"predicted {est.gamma_mb * margin:.0f}MB effective "
                    f"footprint at bs={bs} > budget "
                    f"{self.gamma_budget_mb:.0f}MB")
        if (self.energy_budget_j is not None
                and est.energy_j * margin > self.energy_budget_j):
            return (f"predicted {est.energy_j * margin:.3g}J effective step "
                    f"energy at bs={bs} > budget {self.energy_budget_j:.3g}J")
        slo_ms = request.slo_ms
        if slo_ms is None:
            slo_ms = self.slo.tpot_ms
        if slo_ms is not None:
            tpot = est.phi_ms / self.max_len * margin
            info["tpot_proxy_ms"] = tpot
            if tpot > slo_ms:
                return (f"per-token proxy {tpot:.3f}ms at bs={bs} "
                        f"> SLO {slo_ms:.3f}ms")
        return None

    def admit(self, request, *, n_running: int) -> tuple[Decision, dict]:
        """Price the composed batch and decide.  Never raises: a REFUSE
        returns the decision with the refusal info; the engine turns it
        into a ``PlacementRefused`` on the request."""
        need = request.prompt_len + request.max_new_tokens
        if need > self.max_len:
            return Decision.REFUSE, {
                "reason": f"needs {need} tokens > max_len={self.max_len}"}

        est = self._estimate(n_running + 1, self.max_len)
        if est is None:
            if self._last_miss == "degraded":
                # Static-budget degraded mode: no model-backed level can
                # price the batch, so admission falls back to a
                # conservative fixed concurrency cap.  Over the cap is a
                # DEFER (occupancy drains; the health probe may recover
                # a real backend), never a REFUSE — degraded mode sheds
                # throughput, not requests.
                info = {"degraded": True,
                        "health": self.failover.health.current,
                        "static_slots": self.degraded_slots}
                if n_running < self.degraded_slots:
                    return Decision.ADMIT, info
                info["reason"] = (
                    f"degraded static budget: {n_running} running >= "
                    f"{self.degraded_slots} static slots")
                return Decision.DEFER, info
            # unknown arch / unscorable cell: serve ungated rather than
            # refusing workloads the model can't price (legacy behaviour)
            return Decision.ADMIT, {"skipped": self.unavailable}

        info = self._gate_info(est, n_running + 1)

        # TTFT gate — occupancy-independent: the continuous engine
        # prefills at B=1 over the prompt no matter who else is decoding,
        # so a predicted miss can never clear by waiting → straight
        # REFUSE, never DEFER.
        if self.slo.ttft_ms is not None:
            pest = self._estimate(1, request.prompt_len)
            if pest is not None:
                ttft = pest.phi_ms * (1 + self.safety_margin)
                info["ttft_proxy_ms"] = ttft
                if ttft > self.slo.ttft_ms:
                    info["reason"] = (
                        f"prefill proxy {ttft:.3f}ms for prompt="
                        f"{request.prompt_len} > TTFT SLO "
                        f"{self.slo.ttft_ms:.3f}ms")
                    return Decision.REFUSE, info

        reason = self._batch_reason(est, request, n_running + 1, info)
        if reason is None:
            return Decision.ADMIT, info
        info["reason"] = reason

        # Batch-dependent miss: decide whose fault it is.  Re-priced
        # alone (bs=1) and passing every gate → the current occupancy is
        # the problem, not the request: DEFER, the engine retries next
        # step as slots drain.  Failing even alone → it can never fit:
        # REFUSE for good.
        if n_running > 0:
            alone = self._estimate(1, self.max_len)
            if alone is not None and self._batch_reason(
                    alone, request, 1, dict(info)) is None:
                info["defer"] = "passes every gate alone at bs=1"
                return Decision.DEFER, info
        return Decision.REFUSE, info

    def refusal(self, request, info: dict) -> PlacementRefused:
        breakdown = ""
        if "cost_classes" in info:
            def mag(v):
                # Buckets come in two shapes: a scalar per class (forest
                # detail) or a class_sums dict (analytical detail).
                if isinstance(v, dict):
                    return sum(float(x) for k, x in v.items()
                               if k != "count")
                return float(v)
            top = sorted(info["cost_classes"].items(),
                         key=lambda kv: -mag(kv[1]))[:3]
            breakdown = " [" + ", ".join(
                f"{k}={mag(v):.3g}" for k, v in top) + "]"
        return PlacementRefused(
            f"request {request.rid} (prompt={request.prompt_len}, "
            f"max_new={request.max_new_tokens}) refused: "
            f"{info.get('reason', 'over budget')}{breakdown}", info)
