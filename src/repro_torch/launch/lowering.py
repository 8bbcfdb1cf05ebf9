"""Build the step of one (arch × shape × mesh) cell for timing and
tracing (port of ``repro/launch/lowering.py``, the single-device part).

The reference lowers and compiles the step with ``jax.jit`` over a mesh
and returns the executable and the specs of its arguments; the campaign
runner then materializes zero-filled inputs (``campaign/runner.py``'s
``_materialize``).  The port's step is eager, so :func:`compile_cell`
returns the callable and its arguments, already zero-filled on
``device`` with ``torch.zeros`` (no host draw: the model's parameters are
allocated as zeros where they live), or meta tensors when ``device`` is
``"meta"`` (a trace: nothing is allocated or launched).

* train: ``make_train_step`` — ``loss_fn``, the gradients
  (``torch.autograd.grad``; with ``microbatches > 1`` accumulated in f32
  over batch slices, as the reference's ``lax.scan``), AdamW through
  ``optim.apply_updates``; arguments ``(state, batch)``, ``state =
  {"params", "opt"}``;
* prefill: ``transformer.prefill`` to ``max_len = S + n_prefix``;
  arguments ``(params, batch)``;
* decode: ``transformer.decode_step`` over the dense cache of ``S``
  positions (the reference's decode cell; the paged pool is the serving
  engine's); arguments ``(params, cache, batch)``.

The mesh is validated as the reference's ``make_mesh`` validates it, with
the devices this host has: a cell of more than one device raises
:class:`~repro_torch.launch.mesh.MeshSpecError` naming the deficit.
Sharded execution (``lower_cell``, the mesh placements) waits for ROADMAP
queue 1 item 7c.  Importing this module touches no device state.
"""

from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import validate_mesh_spec
from repro_torch.models import transformer as T
from repro_torch.optim.optimizer import OptimizerConfig, apply_updates, init_opt_state

__all__ = ["make_train_step", "compile_cell", "check_mesh", "mesh_axes",
           "tensors_of"]


def mesh_axes(dims: tuple[int, ...]) -> tuple[str, ...]:
    """The reference's axis names of a mesh-dims tuple (model last)."""
    return ("pod", "data", "model")[-len(dims):]


def check_mesh(dims: tuple[int, ...], device="cuda") -> int:
    """Validate the mesh ``dims`` against the devices of ``device``'s kind
    on this host (the CUDA cards; one for the CPU and for a trace), as
    the reference's ``make_mesh`` does; returns the device count."""
    dims = tuple(int(d) for d in dims)
    dev = torch.device(device)
    available = torch.cuda.device_count() if dev.type == "cuda" else 1
    return validate_mesh_spec(dims, mesh_axes(dims), available=available)


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig, *,
                    microbatches: int = 1):
    """Real train step ``(state, batch) -> (state, metrics)``.

    microbatches — gradient accumulation over batch slices (activation
        temp ∝ 1/M), the gradients summed in f32 and divided by M.
    The state's parameters must require grad; they and the optimizer
    slots are updated in place."""

    def train_step(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        leaves = list(params.values())
        if microbatches == 1:
            l, _ = T.loss_fn(model, batch, cfg)
            grads = dict(zip(params, torch.autograd.grad(l, leaves)))
        else:
            mbs = [{k: v.reshape(microbatches, v.shape[0] // microbatches,
                                 *v.shape[1:])[i] for k, v in batch.items()}
                   for i in range(microbatches)]
            acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for n, p in params.items()}
            l = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for mb in mbs:
                lm, _ = T.loss_fn(model, mb, cfg)
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
    mesh_dims: tuple[int, ...] = (1, 1),
    *,
    device="cuda",
):
    """Build one (cfg × shape) cell's step on ``device``: a train cell
    takes AdamW over the whole batch and the unchunked loss, as the
    campaign measures it.

    Returns ``(step, args, build_s)``: the callable, its positional
    arguments (zero-filled on ``device``, meta tensors for ``"meta"``)
    and the wall-clock seconds of the build.  Raises
    :class:`~repro_torch.launch.mesh.MeshSpecError` when the mesh needs
    more devices than the host has (one for the CPU and for a trace)."""
    dev = T._device(device)          # no card: raise before anything else
    check_mesh(mesh_dims, dev)
    t0 = time.perf_counter()
    B, S = shape.global_batch, shape.seq_len
    model = T.LM(cfg, device=dev)
    if shape.kind == "train":
        opt_cfg = OptimizerConfig()
        for p in model.parameters():
            p.requires_grad_(True)
        state = {"params": model,
                 "opt": init_opt_state(dict(model.named_parameters()), opt_cfg)}
        fn = make_train_step(cfg, opt_cfg)
        args = (state, _zeros_batch(cfg, "train", B, S, dev))
    elif shape.kind == "prefill":
        max_len = S + cfg.n_prefix

        def fn(params, batch):
            return T.prefill(params, batch, cfg, max_len=max_len)

        args = (model, _zeros_batch(cfg, "prefill", B, S, dev))
    else:  # decode
        def fn(params, cache, batch):
            return T.decode_step(params, cache, batch, cfg)

        args = (model, T.init_cache(cfg, B, S, device=dev),
                _zeros_batch(cfg, "decode", B, S, dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return fn, args, time.perf_counter() - t0


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
