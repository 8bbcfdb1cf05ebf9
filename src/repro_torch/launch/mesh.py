"""Mesh-spec validation (port of ``repro/launch/mesh.py``, the part that
needs no device mesh): :class:`MeshSpecError`, :func:`validate_mesh_spec`
and :func:`dp_axes`.

The reference's ``make_mesh`` / ``make_production_mesh`` build a
``jax.sharding.Mesh``; their counterpart (a ``torch.distributed``
DeviceMesh) waits for ROADMAP queue 1 item 7c.  The reference's
``TPU_V5E`` table is a TPU's constants and is not copied: the port reads
its card's constants from ``engine.devices.get_device("h100")`` or
``from_torch_device()``.  Importing this module touches no device state.
"""

from __future__ import annotations

__all__ = ["MeshSpecError", "validate_mesh_spec", "dp_axes"]


class MeshSpecError(ValueError):
    """Structured mesh-spec rejection: what was asked, what was wrong.

    ``needed``/``available``/``deficit`` are populated for device-count
    failures so callers (the planner, the launcher, the campaign runner)
    can report or recover programmatically instead of parsing the
    message."""

    def __init__(self, message: str, *, shape=None, axes=None,
                 needed: int | None = None, available: int | None = None):
        super().__init__(message)
        self.shape = tuple(shape) if shape is not None else None
        self.axes = tuple(axes) if axes is not None else None
        self.needed = needed
        self.available = available
        self.deficit = (needed - available
                        if needed is not None and available is not None
                        else None)


def validate_mesh_spec(shape, axes, available: int | None = None) -> int:
    """Validate a ``(shape, axes)`` mesh request; returns the device count
    it needs: positive dims, matching lengths, unique non-empty axis
    names, and (when ``available`` is given) enough devices, with the
    deficit named in the error."""
    shape = tuple(shape)
    axes = tuple(axes)
    if not shape:
        raise MeshSpecError("empty mesh shape", shape=shape, axes=axes)
    if len(shape) != len(axes):
        raise MeshSpecError(
            f"mesh shape {shape} has {len(shape)} dims but axes {axes} "
            f"name {len(axes)}", shape=shape, axes=axes)
    bad = [d for d in shape if not (isinstance(d, int) and d >= 1)]
    if bad:
        raise MeshSpecError(
            f"mesh shape {shape} has non-positive dim(s) {bad}; every axis "
            "must be an int >= 1", shape=shape, axes=axes)
    if len(set(axes)) != len(axes) or any(not a for a in axes):
        raise MeshSpecError(
            f"mesh axes {axes} must be unique non-empty names",
            shape=shape, axes=axes)
    n = 1
    for d in shape:
        n *= d
    if available is not None and available < n:
        raise MeshSpecError(
            f"mesh {shape} over axes {axes} needs {n} devices but only "
            f"{available} are visible ({n - available} short) — run on a "
            "host with more cards or plan a smaller layout",
            shape=shape, axes=axes, needed=n, available=available)
    return n


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes present on this mesh (pod is outer DP).  Any
    object with ``axis_names`` will do (``distributed.collectives
    .abstract_mesh``)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)
