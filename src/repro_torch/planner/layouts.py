"""Mesh-layout space: the (pipe × data × model) factorizations of a device
count (port of ``repro/planner/layouts.py``, whole; framework-free).

A :class:`MeshLayout` is one candidate placement — ``pipe`` pipeline
stages (outside the GSPMD mesh, splitting the layer stack), ``data``-way
data parallelism and ``model``-way tensor parallelism (the two mesh
axes, model last per the repo-wide ``configs.base.mesh_split``
convention).  :func:`enumerate_layouts` lists every ordered
factorization deterministically; the planner prices them all — pruning
happens by *refusal with a reason* (``planner.LayoutPlanner``), never by
silent omission here.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["MeshLayout", "enumerate_layouts"]


@dataclass(frozen=True, order=True)
class MeshLayout:
    """One (pipe, data, model) parallelism split.  Frozen + ordered so a
    layout list sorts deterministically and works as a dict key."""

    pipe: int
    data: int
    model: int

    def __post_init__(self):
        for f in ("pipe", "data", "model"):
            v = getattr(self, f)
            if not (isinstance(v, int) and v >= 1):
                raise ValueError(f"layout {f} must be an int >= 1, got {v!r}")

    @property
    def n_devices(self) -> int:
        return self.pipe * self.data * self.model

    @property
    def descriptor(self) -> str:
        """``"PxDxM"`` — e.g. the 256-chip production default is
        ``1x16x16`` (no pipeline, 16-way data, 16-way model)."""
        return f"{self.pipe}x{self.data}x{self.model}"

    @property
    def mesh_shape(self) -> tuple[int, int]:
        """The GSPMD mesh dims (model axis last); pipeline stages live
        outside the mesh, so they don't appear here."""
        return (self.data, self.model)

    @property
    def mesh_axes(self) -> tuple[str, str]:
        return ("data", "model")

    @classmethod
    def parse(cls, desc: str) -> "MeshLayout":
        """``"2x4x8"`` → MeshLayout(2, 4, 8); ``"4x8"`` → pipe=1."""
        try:
            dims = tuple(int(x) for x in str(desc).split("x"))
        except ValueError:
            raise ValueError(
                f"bad layout descriptor {desc!r}; expected e.g. '1x16x16'"
            ) from None
        if len(dims) == 2:
            dims = (1,) + dims
        if len(dims) != 3:
            raise ValueError(
                f"bad layout descriptor {desc!r}; expected PxDxM or DxM")
        return cls(*dims)

    def to_dict(self) -> dict:
        return {"pipe": self.pipe, "data": self.data, "model": self.model,
                "descriptor": self.descriptor,
                "mesh_shape": list(self.mesh_shape),
                "mesh_axes": list(self.mesh_axes)}


def _divisors(n: int) -> list[int]:
    out = [d for d in range(1, int(n ** 0.5) + 1) if n % d == 0]
    out += [n // d for d in reversed(out) if d * d != n]
    return out


def enumerate_layouts(n_devices: int, *, max_pipe: int | None = None
                      ) -> list[MeshLayout]:
    """Every ordered (pipe, data, model) triple with product ``n_devices``,
    sorted ascending by (pipe, data, model) — byte-identical across
    processes, so two planners over the same inputs rank the same list.

    ``max_pipe`` caps the pipeline factor at *enumeration* time (a caller
    with no pipeline schedule passes 1 and the pipe>1 column never
    exists); divisibility against the workload is NOT checked here — the
    planner prices or refuses each layout with a recorded reason.
    """
    if not (isinstance(n_devices, int) and n_devices >= 1):
        raise ValueError(f"n_devices must be an int >= 1, got {n_devices!r}")
    out = []
    for p in _divisors(n_devices):
        if max_pipe is not None and p > max_pipe:
            continue
        rest = n_devices // p
        for d in _divisors(rest):
            out.append(MeshLayout(pipe=p, data=d, model=rest // d))
    out.sort()
    return out
