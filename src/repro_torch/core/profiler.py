"""Network-wise profiling strategy (port of ``repro/core/profiler.py``;
paper §5.1, Appendix A).

Each datapoint profiles an *entire* training step — forward pass, backward
pass and the SGD(+momentum) update — never an isolated layer, because
frameworks allocate for whole-network execution (paper §3.1).  This is the
paper's own stack: PyTorch on an NVIDIA GPU, timed with CUDA events.

Attribute definitions (paper §4) for the port:

  Φ (phi_ms)    — latency of one training step (data preparation excluded,
      update included): the median over ``repeats`` steps after ``warmup``
      steps.  On the card each step is timed by CUDA events recorded on the
      current stream around it; on the CPU by ``time.perf_counter``.
  Γ (gamma_mb)  — training-step memory, ``arg + temp + out``:
      * ``arg``: bytes of the parameters, the momentum and the batch, which
        stay resident across steps;
      * on the card, ``temp + out`` is ``torch.cuda.max_memory_allocated``
        over one step, after ``reset_peak_memory_stats``, less the bytes
        allocated just before it, so tensors that outlive the profile (the
        caller's own) do not count.  It counts the caching allocator's
        allocated blocks, not its reserve: memory the allocator holds
        unused is not part of Γ;
      * on the CPU, where no allocator reports a peak, a deterministic
        stand-in that grows with batch size and width: ``temp`` is the
        gradients (one per parameter) plus every tensor autograd saves for
        the backward pass, counted once per storage through
        ``torch.autograd.graph.saved_tensors_hooks`` (storages already in
        ``arg`` are not counted again);
      * ``out`` is the loss: the step updates parameters and momentum in
        place, so they stay in ``arg``;
      * ``code_mb`` is 0: eager PyTorch loads no generated code per model.
      Γ cannot match the reference's, which reads XLA's compile-time buffer
      plan; the two are different measurements of the same attribute.
  compile_s     — seconds of the first call (nothing is compiled; the first
      call pays for library handles and allocator growth).
  flops         — matrix-product and convolution flops of one step
      (``torch.utils.flop_counter.FlopCounterMode``), counted on the meta
      device: the CUDA kernel's launch is invisible to the counter, and
      the meta path computes nothing on the card.  Elementwise work is not
      counted (XLA's cost analysis, in the reference, counts it).

``profile_training`` runs the step ``2 + warmup + repeats`` times on its
device (the first call, the warm-up steps, the timed steps and the memory
step; ``2`` with ``run=False``).  Inference-stage attributes γ/φ (paper
§6.4) are profiled the same way over a forward pass without autograd;
there the CPU stand-in for γ is parameters + batch + logits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.convert import cnn_params_from_numpy, tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.models.cnn import CNNModel

__all__ = [
    "ProfileResult",
    "make_train_step",
    "make_infer_fn",
    "profile_training",
    "profile_inference",
]


@dataclass
class ProfileResult:
    gamma_mb: float          # Γ — total memory (MB)
    phi_ms: float            # Φ — per-step latency (ms)
    compile_s: float         # seconds of the first call (not part of Φ)
    flops: float | None      # matmul + conv flops of one call (meta device)
    temp_mb: float = 0.0
    arg_mb: float = 0.0
    out_mb: float = 0.0
    code_mb: float = 0.0


def make_train_step(model: CNNModel, lr: float = 0.01, momentum: float = 0.9):
    """fwd + bwd + SGD-momentum update, as the paper profiles (§4).

    ``step(params, mom, x, y) -> (params, mom, loss)``: the mean NLL of
    ``log_softmax`` (int labels), its gradients, ``mom = momentum·mom + g``
    and ``p = p − lr·mom``.  Parameters and momentum are updated in place
    (``torch._foreach_*`` under ``no_grad``) and returned."""

    def loss_fn(params, x, y):
        logits = model.apply(params, x)
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(1, y.long()[:, None]).mean()

    def step(params, mom, x, y):
        leaves, moms = tree_leaves(params), tree_leaves(mom)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss = loss_fn(params, x, y)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            torch._foreach_mul_(moms, momentum)
            torch._foreach_add_(moms, grads)
            torch._foreach_add_(leaves, moms, alpha=-lr)
        return params, mom, loss.detach()

    return step


def make_infer_fn(model: CNNModel):
    def infer(params, x):
        with torch.no_grad():
            return model.apply(params, x)

    return infer


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_calls(fn, args, repeats: int, warmup: int, dev: torch.device) -> float:
    """Median ms of one call after ``warmup`` calls."""
    for _ in range(warmup):
        fn(*args)
    _sync(dev)
    if dev.type == "cuda":
        events = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize(dev)
        times = [s.elapsed_time(e) for s, e in events]
    else:
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _storage_key(t: torch.Tensor):
    return t.untyped_storage().data_ptr()


def _memory_step(fn, args, arg_tensors, grad_bytes: int, dev: torch.device):
    """Run ``fn(*args)`` once and return (temp, out) bytes as the module
    docstring defines them for ``dev``."""
    resident = {_storage_key(t) for t in arg_tensors}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = tree_leaves(fn(*args))
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
    else:
        saved: dict[int, int] = {}

        def pack(t):
            st = t.untyped_storage()
            saved[st.data_ptr()] = st.nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = tree_leaves(fn(*args))
        peak = grad_bytes + sum(n for p, n in saved.items() if p not in resident)
    out_bytes = _nbytes(t for t in out if _storage_key(t) not in resident)
    if dev.type == "cuda":          # the peak held the outputs too
        return max(peak - out_bytes, 0), out_bytes
    return peak, out_bytes


def _meta_flops(fn, args) -> float | None:
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), args)
    with FlopCounterMode(display=False) as counter:
        fn(*meta)
    return float(counter.get_total_flops()) or None


def _profile(fn, args, arg_tensors, grad_bytes, dev, repeats, warmup, run):
    t0 = time.perf_counter()
    fn(*args)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    phi_ms = _time_calls(fn, args, repeats, warmup, dev) if run else 0.0
    temp, out = _memory_step(fn, args, arg_tensors, grad_bytes, dev)
    arg = _nbytes(arg_tensors)
    return ProfileResult(
        gamma_mb=(arg + temp + out) / 1e6,
        phi_ms=phi_ms,
        compile_s=compile_s,
        flops=_meta_flops(fn, args),
        temp_mb=temp / 1e6,
        arg_mb=arg / 1e6,
        out_mb=out / 1e6,
        code_mb=0.0,
    )


def _batch(model: CNNModel, bs: int, seed: int, dev: torch.device):
    """The reference's batch: x ~ N(0, 1) NHWC and int32 labels, drawn
    with numpy from ``seed`` after nothing else."""
    np_rng = np.random.default_rng(seed)
    x = np_rng.normal(size=(bs, model.input_hw, model.input_hw, 3)).astype(np.float32)
    y = np_rng.integers(0, model.num_classes, size=(bs,)).astype(np.int32)
    return torch.tensor(x, device=dev), torch.tensor(y, device=dev)


def profile_training(
    model: CNNModel,
    bs: int,
    *,
    repeats: int = 2,
    warmup: int = 1,
    seed: int = 0,
    run: bool = True,
    device="cuda",
) -> ProfileResult:
    """Profile Γ and Φ of one training mini-batch for ``model`` at ``bs``."""
    dev = resolve_device(device)
    params = cnn_params_from_numpy(model.init(seed), device=dev)
    mom = tree_map(torch.zeros_like, params)
    x, y = _batch(model, bs, seed, dev)
    leaves = tree_leaves(params)
    return _profile(make_train_step(model), (params, mom, x, y),
                    leaves + tree_leaves(mom) + [x, y], _nbytes(leaves), dev,
                    repeats, warmup, run)


def profile_inference(
    model: CNNModel,
    bs: int,
    *,
    repeats: int = 3,
    warmup: int = 1,
    seed: int = 0,
    run: bool = True,
    device="cuda",
) -> ProfileResult:
    """Profile γ and φ (inference memory / latency) — paper §6.4."""
    dev = resolve_device(device)
    params = cnn_params_from_numpy(model.init(seed), device=dev)
    x, _ = _batch(model, bs, seed, dev)
    return _profile(make_infer_fn(model), (params, x), tree_leaves(params) + [x],
                    0, dev, repeats, warmup, run)
