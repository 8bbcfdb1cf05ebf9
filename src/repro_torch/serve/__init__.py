"""Serving engines (port of ``repro/serve/``).

Two engines share the model stack and the admission gate:

* :class:`ServeEngine` — the lockstep baseline over a dense KV cache,
  with placement admission through the cost engine.
* :class:`ContinuousEngine` — continuous batching over the paged
  :class:`PagedKVCache` block pool, with chunked prefill, preemption,
  deadlines, seeded fault injection (:class:`FaultPlan`), per-request
  admission by the :class:`SLOScheduler` through a ``CostEngine`` and
  backend failover into static degraded mode (:class:`FailoverChain`).
"""

from repro_torch.serve.continuous import ContinuousConfig, ContinuousEngine
from repro_torch.serve.engine import ServeConfig, ServeEngine, pad_ragged
from repro_torch.serve.faults import FAULT_KINDS, Fault, FaultInjected, FaultPlan
from repro_torch.serve.health import STATIC_LEVEL, FailoverChain
from repro_torch.serve.kv_cache import PagedKVCache, fit_block_size, resolve_block_size
from repro_torch.serve.request import TERMINAL_STATES, Request, RequestState
from repro_torch.serve.scheduler import (
    Decision,
    PlacementRefused,
    ServeSLO,
    SLOScheduler,
)

__all__ = [
    "ContinuousConfig",
    "ContinuousEngine",
    "Decision",
    "FAULT_KINDS",
    "Fault",
    "FaultInjected",
    "FaultPlan",
    "FailoverChain",
    "PagedKVCache",
    "PlacementRefused",
    "Request",
    "RequestState",
    "SLOScheduler",
    "STATIC_LEVEL",
    "ServeConfig",
    "ServeEngine",
    "ServeSLO",
    "TERMINAL_STATES",
    "fit_block_size",
    "pad_ragged",
    "resolve_block_size",
]
