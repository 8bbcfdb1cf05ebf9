"""Production mesh construction (port of ``repro/launch/mesh.py``):
:class:`MeshSpecError`, :func:`validate_mesh_spec`, :func:`make_mesh`,
:func:`make_production_mesh` and :func:`dp_axes`.

The reference builds a ``jax.sharding.Mesh`` over the first
``prod(shape)`` of ``jax.devices()``; the port builds a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks
``0 .. prod(shape) - 1`` of the initialised process group, rank ``r`` at
mesh coordinate ``unravel(r)`` as the reference's device ``r``.  The
devices available are that group's world size: ranks started by
``torchrun`` (``nccl`` on the cards, ``gloo`` on the CPU), or the
``fake`` group of :func:`fake_world`.

:func:`fake_world` is the counterpart of the reference dry-run's
``--xla_force_host_platform_device_count=512``: a ``fake`` process group
of any world size in this one process, whose collectives do nothing.
Over meta tensors a sharded step then traces with per-device shapes and
records the collectives it would run; on real tensors rank 0's shard
runs with collectives that move nothing.  Only the dry-run, the rank-0
measurement and tests use it.

The reference's ``TPU_V5E`` table is a TPU's constants and is not copied:
the port reads its card's constants from ``engine.devices.get_device(
"h100")`` or ``from_torch_device()``.  Importing this module touches no
device state and initialises no process group.
"""

from __future__ import annotations

import contextlib
import functools

__all__ = ["MeshSpecError", "validate_mesh_spec", "make_production_mesh",
           "make_mesh", "fake_world", "is_rank0", "dp_axes", "dtensor_type",
           "is_dtensor"]


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
            f"{available} are visible ({n - available} short) — start more "
            "ranks (torchrun), trace under launch.mesh.fake_world(n) (see "
            "launch/dryrun.py) or plan a smaller layout",
            shape=shape, axes=axes, needed=n, available=available)
    return n


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device="cuda"):
    """A ``DeviceMesh`` of ``device``'s type over the first ``prod(shape)``
    ranks of the initialised process group, after
    :func:`validate_mesh_spec` has vetted the request against the group's
    world size (raising :class:`MeshSpecError` naming the deficit).  The
    axis names are the mesh's ``mesh_dim_names``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    available = dist.get_world_size() if dist.is_initialized() else 1
    n = validate_mesh_spec(shape, axes, available=available)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: start the ranks "
            "with torchrun (or RANK/WORLD_SIZE/MASTER_ADDR) and call "
            "torch.distributed.init_process_group, or trace under "
            "launch.mesh.fake_world(n)")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def fake_world(world_size: int):
    """Initialise the ``fake`` process group of ``world_size`` ranks (this
    process is rank 0; every collective completes and moves nothing),
    yield, and destroy it on exit.  Raises if a process group is already
    initialised."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialised "
                           f"(backend {dist.get_backend()}, world size "
                           f"{dist.get_world_size()})")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(world_size))
    try:
        yield
    finally:
        dist.destroy_process_group()


def is_rank0() -> bool:
    """Whether this process writes shared files: rank 0 of the initialised
    process group, or the only process."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


@functools.cache
def dtensor_type():
    """``DTensor``, or None where ``torch.distributed`` is not built."""
    import torch

    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor

    return DTensor


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor``."""
    t = dtensor_type()
    return t is not None and isinstance(x, t)


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes present on this mesh (pod is outer DP).  Any
    object with ``axis_names`` (``distributed.collectives.abstract_mesh``)
    or ``mesh_dim_names`` (a ``DeviceMesh``) will do."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or of an abstract mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)
