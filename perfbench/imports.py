"""The check that a run measured the port alone: no module of JAX or of
the JAX package (``repro``) is loaded.  Names are compared by their
top-level part, the text before the first dot, as a whole word, so
``repro_torch`` is not ``repro``."""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "forbidden"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(modules=None) -> list[str]:
    """The loaded module names (``sys.modules`` by default) whose
    top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
