"""Admission types of the serve scheduler (port of ``repro/serve/scheduler.py``).

This slice keeps ``PlacementRefused``, ``Decision`` and ``ServeSLO``: the
continuous engine's own refusals (context window, pool capacity, bounded
queue) use them.  ``SLOScheduler`` prices admissions through the cost
engine and comes with the cost-engine slice.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

__all__ = ["Decision", "PlacementRefused", "ServeSLO"]


class PlacementRefused(RuntimeError):
    """A placement or request was refused; ``info`` carries the evidence
    (reason, needed vs available)."""

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
