"""AOT-style lowering of (arch × shape × mesh) cells — shared by the
dry-run and the profiling campaign (port of ``repro/launch/lowering.py``).

The reference lowers and compiles the step with ``jax.jit`` over a mesh
and returns the executable and the specs of its arguments; the campaign
runner then materializes zero-filled inputs (``campaign/runner.py``'s
``_materialize``).  The port's step is eager, so :func:`compile_cell`
returns the callable and its arguments, already zero-filled on
``device`` with ``torch.zeros`` (no host draw: the model's parameters are
allocated as zeros where they live), or meta tensors when ``device`` is
``"meta"`` (a trace: nothing is allocated or launched).

* train: ``make_train_step`` — ``loss_fn`` (``seq_chunk``: the chunked
  CE), the gradients (``torch.autograd.grad``; with ``microbatches > 1``
  accumulated in f32 over batch slices, as the reference's ``lax.scan``),
  the ``opt_kind`` optimizer through ``optim.apply_updates``; arguments
  ``(state, batch)``, ``state = {"params", "opt"}``;
* prefill: ``transformer.prefill`` to ``max_len = S + n_prefix``;
  arguments ``(params, batch)``;
* decode: ``transformer.decode_step`` over the dense cache of ``S``
  positions (the reference's decode cell; the paged pool is the serving
  engine's); arguments ``(params, cache, batch)``.

On a ``DeviceMesh`` the arguments are ``DTensor``s placed by the
reference's ``in_shardings``: ``state_pspecs`` (``opt_kind``, ``fsdp``),
``param_pspecs``, ``batch_pspecs`` and ``cache_pspecs`` through
``distributed.sharding.to_named``, and each call of the step
(:func:`sharded`) installs the activation hint mesh
(``layers.hint_mesh``) and runs under DTensor's implicit replication, so
that the plain tensors a forward makes (positions, masks, the MoE's
dispatch indices) join the sharded ones as replicated.  With a tuple of mesh dims the mesh is validated against the
ranks of the initialised process group (one without a group), as the
reference's ``make_mesh`` validates it against its devices: a short host
raises :class:`~repro_torch.launch.mesh.MeshSpecError` naming the deficit.

:func:`lower_cell` traces the step on meta tensors over a mesh and
returns the reference's ``RooflineReport``: per-device FLOPs and bytes
of the local shards and the collective bytes of the collectives the
sharded step runs (``core/hlo_cost.trace_cost``), the per-device plan
(``core/profiler.meta_memory``), priced on ``hw`` (default: this card's
spec).  Importing this module touches no device state.
"""

from __future__ import annotations

import math
import time

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.launch.mesh import make_mesh, validate_mesh_spec
from repro_torch.models import transformer as T
from repro_torch.optim.optimizer import OptimizerConfig, apply_updates, init_opt_state

__all__ = ["make_train_step", "compile_cell", "lower_cell", "check_mesh",
           "mesh_axes", "tensors_of", "sharded"]


def mesh_axes(dims: tuple[int, ...]) -> tuple[str, ...]:
    """The reference's axis names of a mesh-dims tuple (model last)."""
    return ("pod", "data", "model")[-len(dims):]


def check_mesh(dims: tuple[int, ...], device="cuda") -> int:
    """Validate the mesh ``dims`` against the ranks of the initialised
    process group (one without a group: this process), as the
    reference's ``make_mesh`` validates against its devices; returns the
    device count."""
    import torch.distributed as dist

    dims = tuple(int(d) for d in dims)
    available = dist.get_world_size() if dist.is_initialized() else 1
    return validate_mesh_spec(dims, mesh_axes(dims), available=available)


def sharded(fn, mesh, *, sp: bool = True):
    """``fn`` as a step over ``mesh``: each call runs under DTensor's
    implicit replication (plain tensors made inside join as replicated)
    with the activation hint mesh installed for the call only
    (``layers.hint_mesh``).  The step's ``sp`` is the sequence-parallel
    hint it runs with (``layers.sequence_parallel``: ``sp``, turned off
    and said so where this torch's DTensor cannot run it).  Without a
    mesh, ``fn``."""
    if mesh is None:
        return fn
    from repro_torch.models import layers as L

    sp = L.sequence_parallel(mesh, sp)

    def step(*args):
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication(), L.hint_mesh(mesh, sp=sp):
            return fn(*args)

    step.sp = sp
    return step


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig, *,
                    microbatches: int = 1, seq_chunk: int | None = None):
    """Real train step ``(state, batch) -> (state, metrics)``; perf knobs:

    microbatches — gradient accumulation over batch slices (activation
        temp ∝ 1/M), the gradients summed in f32 and divided by M.
    seq_chunk — chunked CE loss (see transformer.loss_fn).
    The state's parameters must require grad; they and the optimizer
    slots are updated in place."""

    def loss(model, batch):
        return T.loss_fn(model, batch, cfg, seq_chunk=seq_chunk)

    def train_step(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        leaves = list(params.values())
        if microbatches == 1:
            l, _ = loss(model, batch)
            grads = dict(zip(params, torch.autograd.grad(l, leaves)))
        else:
            mbs = [{k: v.reshape(microbatches, v.shape[0] // microbatches,
                                 *v.shape[1:])[i] for k, v in batch.items()}
                   for i in range(microbatches)]
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}
            l = 0.0
            for mb in mbs:
                lm, _ = loss(model, mb)
                for n, g in zip(params, torch.autograd.grad(lm, leaves)):
                    acc[n] += g.float()
                l = l + lm.detach()
            grads = {n: g / microbatches for n, g in acc.items()}
            l = l / microbatches
        _, opt, om = apply_updates(params, grads, state["opt"], opt_cfg)
        return {"params": model, "opt": opt}, {"loss": l.detach(), **om}

    return train_step


def _zeros_batch(cfg: ArchConfig, kind: str, B: int, S: int, device) -> dict:
    """``transformer.input_specs``' batch, zero-filled on ``device``."""
    spec = T.input_specs(cfg, kind, batch_size=B, seq_len=S)["batch"]
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            if isinstance(v, torch.Tensor) else v for k, v in spec.items()}


def compile_cell(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh=(1, 1),
    *,
    opt_kind: str = "adamw",
    fsdp: bool | None = None,
    microbatches: int = 1,
    seq_chunk: int | None = None,
    sp: bool = True,
    device="cuda",
):
    """Build one (cfg × shape) cell's step on ``device`` over ``mesh`` (a
    ``DeviceMesh``, or a tuple of mesh dims built over the group's ranks
    with :func:`~repro_torch.launch.mesh.make_mesh`; a mesh of one device
    builds the unsharded step, as the reference compiles one).

    Returns ``(step, args, build_s)``: the callable (on a mesh,
    :func:`sharded`, whose ``sp`` is the sequence-parallel hint it runs
    with), its positional arguments (zero-filled on ``device``, meta
    tensors for ``"meta"``; DTensors on a mesh) and the wall-clock seconds
    of the build.  Raises
    :class:`~repro_torch.launch.mesh.MeshSpecError` when the mesh needs
    more ranks than the group has."""
    from repro_torch.distributed import sharding as sh

    dev = T._device(device)          # no card: raise before anything else
    if isinstance(mesh, tuple):
        dims = tuple(int(d) for d in mesh)
        check_mesh(dims, dev)
        if math.prod(dims) == 1:
            mesh = None
        elif dev.type == "meta":
            raise ValueError("a traced cell of several devices takes a DeviceMesh "
                             "(launch.mesh.make_mesh under launch.mesh.fake_world)")
        else:
            mesh = make_mesh(dims, mesh_axes(dims), device=dev.type)
    elif mesh.size() == 1:
        mesh = None                     # one device: the unsharded step
    t0 = time.perf_counter()
    B, S = shape.global_batch, shape.seq_len
    model = T.LM(cfg, device=dev)

    def place(tree, specs):
        return tree if mesh is None else sh.distribute_tree(tree, sh.to_named(mesh, specs))

    batch = _zeros_batch(cfg, shape.kind, B, S, dev)
    if mesh is not None:
        batch = place(batch, sh.batch_pspecs(cfg, shape, mesh))
    if shape.kind == "train":
        opt_cfg = OptimizerConfig(kind=opt_kind)
        for p in model.parameters():
            p.requires_grad_(True)
        state = {"params": model,
                 "opt": init_opt_state(dict(model.named_parameters()), opt_cfg)}
        if mesh is not None:
            state = sh.distribute_tree(state, sh.train_state_shardings(
                cfg, mesh, kind=opt_kind, fsdp=fsdp))
        fn = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                             seq_chunk=seq_chunk)
        args = (state, batch)
    elif shape.kind == "prefill":
        max_len = S + cfg.n_prefix

        def fn(params, batch):
            return T.prefill(params, batch, cfg, max_len=max_len)

        if mesh is not None:
            model = place(model, sh.port_params(
                cfg, sh.param_pspecs(cfg, mesh, fsdp=bool(fsdp))))
        args = (model, batch)
    else:  # decode
        def fn(params, cache, batch):
            return T.decode_step(params, cache, batch, cfg)

        cache = T.init_cache(cfg, B, S, device=dev)
        if mesh is not None:
            model = place(model, sh.port_params(cfg, sh.param_pspecs(cfg, mesh)))
            cache = place(cache, sh.cache_pspecs(cfg, shape, mesh))
        args = (model, cache, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return sharded(fn, mesh, sp=sp), args, time.perf_counter() - t0


def lower_cell(
    arch: str,
    shape_name: str,
    mesh,
    mesh_desc: str,
    *,
    opt_kind: str = "adamw",
    remat: bool = True,
    fsdp: bool | None = None,
    print_analysis: bool = True,
    microbatches: int = 1,
    seq_chunk: int | None = None,
    sp: bool = True,
    hw=None,
):
    """Trace one cell's step on meta tensors over ``mesh`` (a
    ``DeviceMesh``); return the roofline report.  ``hw`` (a
    ``DeviceSpec`` or its ``hw_table()``) defaults to this card's spec
    (``engine.devices.from_torch_device()``).  Nothing is launched or
    allocated.  ``remat`` is the reference's signature: both packages
    always remat the training stack."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.hlo_cost import recording
    from repro_torch.core.profiler import _nbytes, meta_memory
    from repro_torch.core.roofline import model_flops_for_cell, roofline_from_cost
    from repro_torch.kernels.autotune import untimed

    if hw is None:
        from repro_torch.engine.devices import from_torch_device

        hw = from_torch_device()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    t0 = time.perf_counter()
    step, args, _ = compile_cell(
        cfg, shape, mesh, opt_kind=opt_kind, fsdp=fsdp,
        microbatches=microbatches, seq_chunk=seq_chunk, sp=sp, device="meta")
    train = shape.kind == "train"
    grad_bytes = _nbytes(tensors_of(args[0]["params"])) if train else 0
    with untimed(), recording() as cost:
        mem = meta_memory(lambda *a: tensors_of(step(*a)), args,
                          tensors_of(list(args)), grad_bytes=grad_bytes,
                          train=train)
    compile_s = time.perf_counter() - t0
    plan_bytes = mem["arg"] + mem["temp"] + mem["out"]
    if print_analysis:
        print({"argument_size_in_bytes": mem["arg"], "temp_size_in_bytes": mem["temp"],
               "output_size_in_bytes": mem["out"]})
        print({"flops": cost.flops, "bytes accessed": cost.hbm_bytes})
    return roofline_from_cost(
        cost,
        arch=arch,
        shape=shape_name,
        mesh_desc=mesh_desc,
        n_devices=mesh.size() if hasattr(mesh, "size") else 1,
        model_flops_total=model_flops_for_cell(cfg, shape),
        hw=hw,
        plan_bytes=plan_bytes,
        compile_s=compile_s,
        sp=getattr(step, "sp", False),
    )


def tensors_of(tree) -> list[torch.Tensor]:
    """Every tensor of a step's arguments or outputs, a model's parameters
    included, in ``tree_leaves`` order (ints and other leaves dropped)."""
    from repro_torch.convert import tree_leaves

    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.nn.Module):
            out += list(leaf.parameters())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out
