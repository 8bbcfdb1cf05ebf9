"""Pipeline parallelism: the bubble of a GPipe-style schedule (port of
``repro/distributed/pipeline_parallel.py``, ``bubble_fraction`` only).

The schedule runs ``n_micro + n_stages − 1`` ticks, so the bubble
fraction is (S−1)/(M+S−1); the layout accounting prices it.  The
schedule itself (``pipeline_apply``) waits for ROADMAP queue 1 item 7c.
"""

from __future__ import annotations

__all__ = ["bubble_fraction"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
