"""Serving engines (port of ``repro/serve/``).

* :class:`ServeEngine` — the lockstep baseline over a dense KV cache.
* :class:`ContinuousEngine` — continuous batching over the paged
  :class:`PagedKVCache` block pool, with chunked prefill, preemption,
  deadlines and seeded fault injection (:class:`FaultPlan`).

Cost-engine admission (``SLOScheduler``, ``FailoverChain``) comes with a
later slice.
"""

from repro_torch.serve.continuous import ContinuousConfig, ContinuousEngine
from repro_torch.serve.engine import ServeConfig, ServeEngine, pad_ragged
from repro_torch.serve.faults import FAULT_KINDS, Fault, FaultInjected, FaultPlan
from repro_torch.serve.kv_cache import PagedKVCache, resolve_block_size
from repro_torch.serve.request import TERMINAL_STATES, Request, RequestState
from repro_torch.serve.scheduler import Decision, PlacementRefused, ServeSLO

__all__ = [
    "ContinuousConfig",
    "ContinuousEngine",
    "Decision",
    "FAULT_KINDS",
    "Fault",
    "FaultInjected",
    "FaultPlan",
    "PagedKVCache",
    "PlacementRefused",
    "Request",
    "RequestState",
    "ServeConfig",
    "ServeEngine",
    "ServeSLO",
    "TERMINAL_STATES",
    "pad_ragged",
    "resolve_block_size",
]
