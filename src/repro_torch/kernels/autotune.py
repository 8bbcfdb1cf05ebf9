"""Kernel autotuner: roofline-pruned block-size search, device-keyed cache
(port of ``repro/kernels/autotune.py``).

The reference's three stages, unchanged in shape:

1. **Enumerate** — each kernel package registers a :class:`TilingModel`
   whose ``candidates(shape)`` lists the legal block configurations for a
   launch shape (always including the static default).
2. **Prune + rank** — ``cost(shape, config)`` returns a static
   :class:`KernelCost`; candidates whose on-chip working set exceeds the
   budget are rejected, the rest ranked by roofline time under a
   :class:`~repro_torch.engine.devices.DeviceSpec`.
3. **Measure** — the top-K survivors are timed through the tiling
   model's ``runner`` where the spec's kernels can run; elsewhere the
   model ranking alone decides.

What depends on the spec.  Under any spec without ``meta["platform"] ==
"gpu"`` (``tpu_v5e``, ``host_cpu``, ``tx2_like``) the port ranks exactly
as the reference does: budget ``VMEM_BYTES × VMEM_BUDGET_FRACTION``
against ``KernelCost.vmem_bytes``, the ``MXU_DIM`` underfill term, cache
keys byte-identical.  Under a CUDA spec (``h100``, or
:func:`~repro_torch.engine.devices.from_torch_device` on a card):

* feasibility is shared memory per block, ``KernelCost.smem_bytes``
  (the port's CUDA kernel's own working set at that config, as each
  tiling model's docstring says) against ``SMEM_BYTES_PER_BLOCK`` =
  232,448 B, the most a Hopper block can opt into; ``explain()``'s
  ``vmem_kb`` and ``rejected_vmem`` then read shared memory;
* the ``MXU_DIM`` underfill term is dropped.  The ranking does not model
  the card's units: the f32 kernels run FMAs on the CUDA cores, whose rate
  does not depend on how wide a matmul operand is, while bf16 flash
  attention runs ``wgmma`` on the tensor cores in fixed 64-row,
  64/128-key tiles that no config narrows below the instruction's
  width (a tensor-core underfill term for narrow shapes is open work);
* ``measure=None`` times on the card when CUDA is available:
  ``torch.cuda.synchronize`` around ``time.perf_counter``, the minimum of
  three calls after one warm call, as the reference times on a TPU.

A runner's exception propagates out of :meth:`KernelTuner.tune`; the
implicit-lookup wrapper :func:`tuned_config` falls back to the default
only when the cache file cannot be read or written (``OSError``), the
reference's stated reason.  Launches a kernel makes while the tuner
times it are counted apart from the main path's (:func:`timing_launches`).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time
from dataclasses import dataclass
from typing import Callable

from repro_torch.core.fileio import atomic_write_json, load_json_tolerant
from repro_torch.costmodel import OpCost

__all__ = [
    "KernelCost",
    "TilingModel",
    "TuningCache",
    "KernelTuner",
    "register_tiling",
    "get_tiling",
    "list_tilings",
    "roofline_seconds",
    "vmem_ok",
    "smem_ok",
    "is_cuda_spec",
    "largest_dividing_block",
    "bytes_per_element",
    "autotune_enabled",
    "get_tuner",
    "set_tuner",
    "tuned_config",
    "timing_launches",
]

# TPU v5e-class VMEM per core and the reference's headroom fraction.
VMEM_BYTES = 16 * 1024 * 1024
VMEM_BUDGET_FRACTION = 0.9

# Hopper: the most dynamic shared memory one block can opt into (227 KB of
# the SM's 256 KB, after cudaFuncSetAttribute).
SMEM_BYTES_PER_BLOCK = 232_448

# MXU systolic-array edge: matmul operand dims below this underfill the
# unit, scaling effective peak FLOP/s by ~dim/128 (TPU specs only).
MXU_DIM = 128

# Per sequenced step (grid program or inner loop trip): an order-of-
# magnitude constant that breaks ties between configs with identical
# roofline terms (favouring fewer, larger blocks).
STEP_OVERHEAD_S = 2e-7

BYTES_PER_ELEMENT = {
    "float32": 4, "bfloat16": 2, "float16": 2, "float64": 8, "int8": 1,
}


def bytes_per_element(dtype) -> int:
    """Bytes of one element; accepts ``torch.bfloat16`` or ``"bfloat16"``."""
    return BYTES_PER_ELEMENT.get(str(dtype).removeprefix("torch."), 4)


def largest_dividing_block(n: int, requested: int | None) -> int:
    """Largest block size that divides ``n`` and is ≤ ``requested``.

    A requested block that doesn't tile the dimension evenly degrades to
    the nearest legal (dividing) size instead of failing the launch.
    ``None`` or a request ≥ n yields n itself (single block)."""
    n = int(n)
    if n <= 0:
        raise ValueError(f"cannot block a non-positive dim: {n}")
    b = max(1, min(int(requested) if requested else n, n))
    while n % b:
        b -= 1
    return b


@dataclass(frozen=True, kw_only=True)
class KernelCost(OpCost):
    """Static cost of one kernel launch under one block configuration — a
    view over :class:`~repro_torch.costmodel.OpCost`.

    ``n_steps`` counts sequenced steps (grid programs plus inner-loop
    trips), each paying ``STEP_OVERHEAD_S``; ``mxu_min_dim`` is the
    smallest matmul operand dim, which scales a TPU's MXU peak by
    ``min(1, dim/128)``; ``smem_bytes`` is the shared memory one block of
    the port's CUDA kernel takes at this config (0 where the op has no
    CUDA kernel), the budget under a CUDA spec."""

    n_steps: int = 1
    mxu_min_dim: int = MXU_DIM
    smem_bytes: float = 0.0


def is_cuda_spec(device) -> bool:
    """Whether a DeviceSpec describes a CUDA card (``meta["platform"]``)."""
    return (getattr(device, "meta", None) or {}).get("platform") == "gpu"


def vmem_ok(cost: KernelCost, *, budget_bytes: float | None = None) -> bool:
    limit = (VMEM_BYTES * VMEM_BUDGET_FRACTION
             if budget_bytes is None else budget_bytes)
    return cost.vmem_bytes <= limit


def smem_ok(cost: KernelCost, *, budget_bytes: float | None = None) -> bool:
    limit = SMEM_BYTES_PER_BLOCK if budget_bytes is None else budget_bytes
    return cost.smem_bytes <= limit


def _onchip_bytes(cost: KernelCost, device) -> float:
    return cost.smem_bytes if is_cuda_spec(device) else cost.vmem_bytes


def roofline_seconds(cost: KernelCost, device) -> float:
    """Modelled launch time on ``device`` (a DeviceSpec): the roofline over
    the spec's denominators through ``DeviceSpec.combine_terms`` plus the
    per-step sequencing overhead.  The MXU underfill factor applies to
    non-CUDA specs only (see the module docstring)."""
    util = (1.0 if is_cuda_spec(device)
            else min(1.0, max(int(cost.mxu_min_dim), 1) / MXU_DIM))
    t = device.combine_terms(
        cost.flops / (device.peak_flops * util),
        cost.hbm_bytes / device.hbm_bw,
    )
    return t + cost.n_steps * STEP_OVERHEAD_S


@dataclass(frozen=True)
class TilingModel:
    """One kernel's tiling search space and static cost model.

    ``candidates(shape) -> list[dict]`` — legal block configs (must
    include ``default(shape)``).
    ``cost(shape, config) -> KernelCost`` — static launch cost.
    ``default(shape) -> dict`` — the kernel's hand-picked constants.
    ``runner(shape, config) -> Callable[[], None]`` — optional: a zero-arg
    closure that launches the real kernel on the card (for timing).
    """

    name: str
    candidates: Callable
    cost: Callable
    default: Callable
    runner: Callable | None = None


_TILINGS: dict[str, TilingModel] = {}
_BUILTIN_MODULES = (
    "repro_torch.kernels.conv_mm.tiling",
    "repro_torch.kernels.flash_attention.tiling",
    "repro_torch.kernels.ssm_scan.tiling",
    "repro_torch.kernels.moe_dispatch.tiling",
    "repro_torch.kernels.serve_kv.tiling",
    "repro_torch.kernels.paged_decode.tiling",
)


def register_tiling(model: TilingModel, *, overwrite: bool = False) -> TilingModel:
    if model.name in _TILINGS and not overwrite:
        raise ValueError(f"tiling {model.name!r} already registered")
    _TILINGS[model.name] = model
    return model


def _ensure_builtin() -> None:
    import importlib

    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)


def get_tiling(name: str) -> TilingModel:
    if name not in _TILINGS:
        _ensure_builtin()
    try:
        return _TILINGS[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel tiling {name!r}; registered: {sorted(_TILINGS)}"
        ) from None


def list_tilings() -> list[str]:
    _ensure_builtin()
    return sorted(_TILINGS)


# ---------------------------------------------------------------------------
# Persistence: the tuning cache (on core/fileio).
# ---------------------------------------------------------------------------


class TuningCache:
    """Content-keyed on-disk winners: {key: {"config": ..., meta...}}.

    Keys are sha1(kernel | canonical shape json | device fingerprint) —
    built by :meth:`KernelTuner.key`, byte-identical to the reference's, so
    a file written by either package's tuner serves the other.  Atomic
    writes; a corrupt file is quarantined and restarted from empty."""

    def __init__(self, path: str):
        self.path = path
        self._data: dict[str, dict] = load_json_tolerant(path)

    def get(self, key: str) -> dict | None:
        entry = self._data.get(key)
        return dict(entry) if entry else None

    def put(self, key: str, entry: dict) -> None:
        self._data[key] = dict(entry)

    def entries(self) -> list[dict]:
        return [dict(e) for e in self._data.values()]

    def flush(self) -> None:
        # Merge-on-flush: tuners sharing one path append, not clobber; a
        # colliding key carries the same shape and device.
        on_disk = load_json_tolerant(self.path)
        if on_disk:
            self._data = {**on_disk, **self._data}
        atomic_write_json(self.path, self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: str) -> bool:
        return key in self._data


# ---------------------------------------------------------------------------
# Launch accounting while the tuner times a runner.
# ---------------------------------------------------------------------------

_TIMING_DEPTH = 0


def timing_launches() -> bool:
    """True while :meth:`KernelTuner._time_top_k` runs a runner: kernel
    wrappers count such launches in ``tuner_launches``, apart from the
    ``launches`` of the path that asked for the tuning."""
    return _TIMING_DEPTH > 0


@contextlib.contextmanager
def _timing():
    global _TIMING_DEPTH
    _TIMING_DEPTH += 1
    try:
        yield
    finally:
        _TIMING_DEPTH -= 1


# ---------------------------------------------------------------------------
# The tuner.
# ---------------------------------------------------------------------------


class KernelTuner:
    """Roofline-pruned block-size search with per-device memoization.

    ``tune(kernel, shape)`` resolution order: in-process memo → on-disk
    :class:`TuningCache` → model-pruned search (→ top-K timed on the card
    when measuring and a runner exists).  ``hits``/``misses``/``timed``
    count those paths.  ``vmem_budget_bytes`` overrides the on-chip budget
    of whichever memory the spec budgets (VMEM, or shared memory under a
    CUDA spec).
    """

    def __init__(self, device=None, cache: TuningCache | str | None = None,
                 *, top_k: int = 3, measure: bool | None = None,
                 vmem_budget_bytes: float | None = None):
        self._device = device
        self.cache = TuningCache(cache) if isinstance(cache, str) else cache
        self.top_k = max(1, int(top_k))
        self.measure = measure
        self.vmem_budget_bytes = vmem_budget_bytes
        self._memo: dict[str, dict] = {}
        self.hits = 0
        self.misses = 0
        self.timed = 0

    # -- device ------------------------------------------------------------

    @property
    def device(self):
        """The DeviceSpec keys are salted with (derived from the live torch
        device when not configured).  Imported here, as in the reference:
        the engine package imports the core modules, which import the
        kernels."""
        if self._device is None:
            from repro_torch.engine.devices import from_torch_device

            self._device = from_torch_device()
        elif isinstance(self._device, (str, dict)):
            from repro_torch.engine.devices import resolve_device

            self._device = resolve_device(self._device)
        return self._device

    def _should_measure(self) -> bool:
        if self.measure is not None:
            return self.measure
        import torch

        return is_cuda_spec(self.device) and torch.cuda.is_available()

    def _fits(self, cost: KernelCost) -> bool:
        if is_cuda_spec(self.device):
            return smem_ok(cost, budget_bytes=self.vmem_budget_bytes)
        return vmem_ok(cost, budget_bytes=self.vmem_budget_bytes)

    # -- keys --------------------------------------------------------------

    def key(self, kernel: str, shape: dict) -> str:
        blob = f"{kernel}|{json.dumps(shape, sort_keys=True)}|{self.device.fingerprint()}"
        return hashlib.sha1(blob.encode()).hexdigest()

    # -- search ------------------------------------------------------------

    def tune(self, kernel: str, shape: dict) -> dict:
        """Best block config for one concrete launch shape (a plain dict
        of static kwargs for the kernel, e.g. ``{"block_q": 512, ...}``)."""
        key = self.key(kernel, shape)
        entry = self._memo.get(key)
        if entry is None and self.cache is not None:
            entry = self.cache.get(key)
            if entry is not None:
                self._memo[key] = entry
        if entry is not None:
            self.hits += 1
            return dict(entry["config"])
        self.misses += 1
        entry = self._search(get_tiling(kernel), shape)
        self._memo[key] = entry
        if self.cache is not None:
            self.cache.put(key, entry)
            self.cache.flush()
        return dict(entry["config"])

    def explain(self, kernel: str, shape: dict) -> dict:
        """The full cached entry (config + modelled times + provenance)."""
        self.tune(kernel, shape)
        return dict(self._memo[self.key(kernel, shape)])

    def _search(self, tiling: TilingModel, shape: dict) -> dict:
        device = self.device
        default = tiling.default(shape)
        cands = list(tiling.candidates(shape))
        if default not in cands:
            cands.append(default)

        scored = []
        rejected_vmem = 0
        for cfg in cands:
            cost = tiling.cost(shape, cfg)
            if not self._fits(cost):
                rejected_vmem += 1
                continue
            scored.append((roofline_seconds(cost, device), cost, cfg))
        if not scored:
            # Nothing fits the budget: least-infeasible candidate, flagged
            # by rejected_vmem == candidates.
            cost_cfgs = [(tiling.cost(shape, c), c) for c in cands]
            cost, cfg = min(cost_cfgs, key=lambda t: _onchip_bytes(t[0], device))
            scored = [(roofline_seconds(cost, device), cost, cfg)]
        scored.sort(key=lambda t: (t[0], json.dumps(t[2], sort_keys=True)))

        best_t, best_cost, best_cfg = scored[0]
        source = "model"
        if self._should_measure() and tiling.runner is not None:
            best_t, best_cfg = self._time_top_k(tiling, shape, scored)
            best_cost = tiling.cost(shape, best_cfg)
            source = "timed"

        default_cost = tiling.cost(shape, default)
        return {
            "kernel": tiling.name,
            "config": dict(best_cfg),
            "shape": dict(shape),
            "source": source,
            "device": device.name,
            "model_us": best_t * 1e6 if source == "model" else
            roofline_seconds(best_cost, device) * 1e6,
            "measured_us": best_t * 1e6 if source == "timed" else None,
            "default_config": dict(default),
            "default_model_us": roofline_seconds(default_cost, device) * 1e6,
            "vmem_kb": _onchip_bytes(best_cost, device) / 1024,
            "candidates": len(cands),
            "rejected_vmem": rejected_vmem,
        }

    def _time_top_k(self, tiling: TilingModel, shape: dict, scored) -> tuple[float, dict]:
        import torch

        def sync():
            if torch.cuda.is_available():
                torch.cuda.synchronize()

        best = (float("inf"), scored[0][2])
        for _, _, cfg in scored[: self.top_k]:
            with _timing():
                fn = tiling.runner(shape, cfg)
                fn()  # warm: first launch, library load
                sync()
                ts = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    fn()
                    sync()
                    ts.append(time.perf_counter() - t0)
            self.timed += 1
            t = min(ts)
            if t < best[0]:
                best = (t, cfg)
        return best


# ---------------------------------------------------------------------------
# Process-default tuner: what the ops wrappers and model code consult when
# no explicit block sizes are passed.
# ---------------------------------------------------------------------------

_DEFAULT_TUNER: KernelTuner | None = None


def autotune_enabled() -> bool:
    """Gate for implicit tuning at ops/model call sites (``REPRO_AUTOTUNE=0``
    restores the hand-picked constants everywhere, as in the reference)."""
    return os.environ.get("REPRO_AUTOTUNE", "1") != "0"


def _default_cache_path() -> str:
    from repro_torch.kernels.build import BUILD_DIR

    return os.environ.get("REPRO_TORCH_TUNING_CACHE",
                          str(BUILD_DIR / "kernel_tuning.json"))


def get_tuner() -> KernelTuner:
    global _DEFAULT_TUNER
    if _DEFAULT_TUNER is None:
        _DEFAULT_TUNER = KernelTuner(cache=_default_cache_path())
    return _DEFAULT_TUNER


def set_tuner(tuner: KernelTuner | None) -> None:
    """Install (or with None, reset) the process-default tuner."""
    global _DEFAULT_TUNER
    _DEFAULT_TUNER = tuner


def tuned_config(kernel: str, shape: dict, default: dict | None = None) -> dict:
    """Tuned config for implicit call sites: ``default`` (or {}) when
    autotuning is disabled or the cache file cannot be read or written (a
    forward must not die because a cache directory is read-only).  Any
    other error — a runner's kernel launch failing on the card — raises."""
    if not autotune_enabled():
        return dict(default or {})
    try:
        return get_tuner().tune(kernel, shape)
    except OSError:
        return dict(default or {})
