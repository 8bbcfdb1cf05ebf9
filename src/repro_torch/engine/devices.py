"""Device registry: named hardware constants behind every cost estimate
(port of ``repro/engine/devices.py``).

A :class:`DeviceSpec` carries the roofline denominators (peak FLOP/s,
memory bandwidth, interconnect bandwidth), the fitted latency constants
(kernel launch overhead, term-combination mode) and the fitted memory
constants (allocator granularity, weight/activation scale, base
footprint).  ``FITTED_FIELDS`` and :meth:`DeviceSpec.fingerprint` are the
reference's, unchanged, so a spec with the same constants hashes to the
same fingerprint in both packages and the kernel autotuner's cache keys
agree between them.

Specs come from:

* the built-in registry — the reference's ``host_cpu``, ``tx2_like`` and
  ``tpu_v5e``, plus ``h100`` (NVIDIA data-sheet numbers), all
  ``calibrated=False``;
* :func:`from_torch_device` — derived from the live CUDA device (or the
  CPU), beside the reference's ``from_jax_device``;
* :func:`load_device_spec` — a persisted spec, JSON or NPZ by extension,
  written atomically through ``core/fileio``.

``meta["platform"]`` says what runs the kernels: ``"gpu"`` on ``h100``
and on a spec derived from a CUDA device, where the autotuner budgets
shared memory per block and times on the card
(:mod:`repro_torch.kernels.autotune`).  ``meta`` is not part of the
fingerprint.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from dataclasses import asdict, dataclass, field, replace

__all__ = [
    "DeviceSpec",
    "DEVICE_REGISTRY",
    "FITTED_FIELDS",
    "POWER_MODE_FIELDS",
    "get_device",
    "register_device",
    "list_devices",
    "resolve_device",
    "from_torch_device",
    "save_device_spec",
    "load_device_spec",
]

# Constants that change predictions — exactly the fields the fingerprint
# (and therefore every estimate-cache key) must be sensitive to.
# ``calibrated`` is included because the analytical backend branches on it
# (fitted memory model, infer-stage combine), not just on the constants.
FITTED_FIELDS = (
    "peak_flops",
    "hbm_bw",
    "ici_bw",
    "hbm_bytes",
    "launch_overhead_s",
    "alloc_granularity",
    "mem_weight_scale",
    "mem_act_scale",
    "mem_base_mb",
    "idle_w",
    "peak_w",
    "power_modes",
    "combine",
    "calibrated",
    "class_coeffs",
)

# DeviceSpec fields a named power-mode entry may override (a nvpmodel-style
# mode caps the power budget *and* the clocks, so the roofline denominators
# are legitimately part of a mode).
POWER_MODE_FIELDS = ("idle_w", "peak_w", "peak_flops", "hbm_bw")


@dataclass(frozen=True)
class DeviceSpec:
    """Hardware constants of one device, guessed or fitted.

    Latency model (``AnalyticalBackend``):

        phi_s = launch_overhead_s + combine(flops / peak_flops,
                                            bytes_moved / hbm_bw)

    where ``combine`` is ``max`` (classic roofline, the uncalibrated
    default) or ``sum`` (the additive relaxation the NNLS calibration
    fits — overlap folded into the fitted denominators).

    Memory model:

        gamma_mb = mem_base_mb + mem_weight_scale * weight_mb
                              + mem_act_scale   * activation_mb

    with byte totals rounded up to ``alloc_granularity``.  The uncalibrated
    defaults (scale 1, base 0, granularity 1) leave the raw Appendix-B
    allocation totals untouched.

    Power envelope (PowerTrain / the Jetson characterization papers):
    ``idle_w`` is the board's static draw, ``peak_w`` its full-utilisation
    draw; the dynamic range ``max(peak_w - idle_w, 0)`` scales with
    roofline utilisation to give analytical energy (see
    ``engine/decompose.energy_terms``).  ``power_modes`` optionally names
    nvpmodel-style operating points (``{"MAXQ": {"peak_w": 7.5, ...}}``,
    each entry overriding :data:`POWER_MODE_FIELDS`); apply one with
    :meth:`with_power_mode`.  The zero-watt default keeps envelope energy
    inert (0 J) on specs that never declared one.
    """

    name: str
    peak_flops: float                  # FLOP/s
    hbm_bw: float                      # B/s
    ici_bw: float = 1e9                # B/s (interconnect / collective)
    hbm_bytes: float = 4e9             # memory capacity
    launch_overhead_s: float = 0.0     # fixed per-step dispatch cost
    alloc_granularity: int = 1         # allocator rounding (bytes)
    mem_weight_scale: float = 1.0      # measured MB per modeled weight MB
    mem_act_scale: float = 1.0         # measured MB per modeled activation MB
    mem_base_mb: float = 0.0           # fixed runtime footprint
    idle_w: float = 0.0                # static board draw (W)
    peak_w: float = 0.0                # full-utilisation draw (W)
    combine: str = "max"               # "max" roofline | "sum" calibrated
    calibrated: bool = False
    # Named operating points (nvpmodel-style): {mode: {field: value}} with
    # fields restricted to POWER_MODE_FIELDS.  hash=False for the same
    # reason as class_coeffs below.
    power_modes: dict = field(default_factory=dict, hash=False)
    # Class-wise fitted constants (the per-op cost ledger refactor): maps a
    # fit family ("cnn_latency", "lm_latency") to {column: seconds-per-unit}
    # coefficients over the engine/decompose class columns, with the fit's
    # intercept under "_intercept".  Empty dict = aggregate constants only.
    # hash=False: a dict would make the frozen spec unhashable; identity
    # for hashing purposes is the fingerprint (which covers this field).
    class_coeffs: dict = field(default_factory=dict, hash=False)
    meta: dict = field(default_factory=dict, compare=False)

    def __post_init__(self):
        if self.peak_flops <= 0 or self.hbm_bw <= 0:
            raise ValueError(f"non-positive roofline denominator: {self}")
        if self.combine not in ("max", "sum"):
            raise ValueError(f"combine must be 'max' or 'sum', got {self.combine!r}")
        if self.alloc_granularity < 1:
            raise ValueError(f"alloc_granularity must be >= 1: {self}")
        if self.idle_w < 0 or self.peak_w < 0:
            raise ValueError(f"negative power envelope: {self}")
        for mode, entry in self.power_modes.items():
            bad = set(entry) - set(POWER_MODE_FIELDS)
            if bad:
                raise ValueError(
                    f"power mode {mode!r} overrides non-mode fields {sorted(bad)}"
                    f" (allowed: {POWER_MODE_FIELDS})")

    # -- prediction helpers --------------------------------------------------

    @property
    def dynamic_w(self) -> float:
        """Utilisation-scaled power range.  Clamped at 0 so a partially
        declared envelope (idle only) stays inert rather than negative."""
        return max(self.peak_w - self.idle_w, 0.0)

    def with_power_mode(self, mode: str) -> "DeviceSpec":
        """The spec at a named operating point: ``power_modes[mode]``
        overrides applied, name suffixed ``@mode``, fingerprint distinct."""
        try:
            entry = self.power_modes[mode]
        except KeyError:
            raise KeyError(
                f"device {self.name!r} has no power mode {mode!r}; "
                f"available: {sorted(self.power_modes)}") from None
        return replace(self, name=f"{self.name}@{mode}", **entry)

    def combine_terms(self, *terms_s: float) -> float:
        """Fold roofline terms into seconds, plus the launch overhead."""
        folded = max(terms_s) if self.combine == "max" else sum(terms_s)
        return self.launch_overhead_s + folded

    def round_alloc(self, nbytes: float) -> float:
        """Round a byte total up to the allocator granularity."""
        g = self.alloc_granularity
        return nbytes if g <= 1 else math.ceil(nbytes / g) * g

    # -- identity ------------------------------------------------------------

    def fingerprint(self) -> str:
        """Hash of every fitted constant (not the name or meta).

        Deliberately conservative: ``hbm_bytes`` only affects admission
        budgets, not estimates, but is still in the key — editing a spec's
        capacity invalidates its cached estimates (a harmless recompute)
        rather than risking any constant change silently aliasing."""
        blob = json.dumps([getattr(self, f) for f in FITTED_FIELDS],
                          sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def hw_table(self) -> dict:
        """Legacy roofline dict (``core/roofline.py`` key names)."""
        return {
            "peak_flops_bf16": self.peak_flops,
            "hbm_bw": self.hbm_bw,
            "ici_bw": self.ici_bw,
            "hbm_bytes": self.hbm_bytes,
        }

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DeviceSpec":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_hw_table(cls, hw: dict, name: str = "custom") -> "DeviceSpec":
        """Adopt a legacy ``{"peak_flops_bf16": ..., "hbm_bw": ...}`` dict."""
        return cls(
            name=name,
            peak_flops=float(hw["peak_flops_bf16"]),
            hbm_bw=float(hw["hbm_bw"]),
            ici_bw=float(hw.get("ici_bw", 1e9)),
            hbm_bytes=float(hw.get("hbm_bytes", 4e9)),
        )


# ---------------------------------------------------------------------------
# Registry.  host_cpu, tx2_like (the paper's Jetson TX2, §6: 256-core
# Pascal, 8 GB unified LPDDR4) and tpu_v5e are the reference's entries,
# constant for constant; h100 is the port's card.
# ---------------------------------------------------------------------------

DEVICE_REGISTRY: dict[str, DeviceSpec] = {}


def register_device(spec: DeviceSpec, *, overwrite: bool = False) -> DeviceSpec:
    if spec.name in DEVICE_REGISTRY and not overwrite:
        raise ValueError(f"device {spec.name!r} already registered")
    DEVICE_REGISTRY[spec.name] = spec
    return spec


def get_device(name: str) -> DeviceSpec:
    try:
        return DEVICE_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown device {name!r}; registered: {sorted(DEVICE_REGISTRY)}"
        ) from None


def list_devices() -> list[str]:
    return sorted(DEVICE_REGISTRY)


register_device(DeviceSpec(
    name="host_cpu",
    peak_flops=5e10,        # 1-core CPU stand-in for the edge device
    hbm_bw=2e10,
    ici_bw=1e9,             # loopback; collectives are degenerate
    hbm_bytes=4e9,
    idle_w=10.0,            # desktop-class package idle
    peak_w=65.0,            # typical TDP
))

register_device(DeviceSpec(
    name="tx2_like",
    peak_flops=1.33e12,     # TX2 256-core Pascal, fp16
    hbm_bw=59.7e9,          # LPDDR4 128-bit
    ici_bw=1e9,
    hbm_bytes=8e9,          # unified memory
    launch_overhead_s=2e-4, # CUDA kernel dispatch per step (order-of-magnitude)
    alloc_granularity=512,  # CUDA caching-allocator block rounding
    idle_w=1.4,             # module idle, board rails excluded
    peak_w=15.0,            # MAXN budget
    # nvpmodel-style operating points (Jetson characterization paper):
    # MAXQ caps the budget at 7.5 W by halving clocks — the roofline
    # denominators move with the envelope, not just the watts.
    power_modes={
        "MAXN": {"idle_w": 1.4, "peak_w": 15.0},
        "MAXQ": {"idle_w": 1.4, "peak_w": 7.5,
                 "peak_flops": 0.67e12, "hbm_bw": 40.6e9},
        "MAXP_CORE_ALL": {"idle_w": 1.4, "peak_w": 11.0,
                          "peak_flops": 1.12e12},
    },
))

register_device(DeviceSpec(
    name="tpu_v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    hbm_bytes=16e9,
    idle_w=55.0,            # order-of-magnitude chip+HBM idle
    peak_w=170.0,
))


register_device(DeviceSpec(
    name="h100",
    # NVIDIA H100 SXM data sheet (dense, no sparsity, at the 700 W limit):
    # 989 TFLOP/s bf16 tensor-core peak, 3.35 TB/s HBM3, 80 GB.  Data-sheet
    # numbers, not measured here.  ici_bw is one NVLink direction (450 GB/s).
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    hbm_bytes=80e9,
    peak_w=700.0,
    meta={"platform": "gpu", "device_kind": "NVIDIA H100 SXM (data sheet)"},
))


# ---------------------------------------------------------------------------
# Resolution and auto-derivation.
# ---------------------------------------------------------------------------


def resolve_device(device, default: str = "host_cpu") -> DeviceSpec:
    """Turn any accepted device description into a :class:`DeviceSpec`.

    Accepts a spec (returned as-is), a registry name, a path to a persisted
    spec (``.json`` / ``.npz``), a legacy hardware-constant dict, or ``None``
    (the registry ``default``).
    """
    if device is None:
        return get_device(default)
    if isinstance(device, DeviceSpec):
        return device
    if isinstance(device, dict):
        return DeviceSpec.from_hw_table(device)
    if isinstance(device, str):
        if device in DEVICE_REGISTRY:
            return get_device(device)
        if device.endswith((".json", ".npz")) or os.sep in device:
            return load_device_spec(device)
        return get_device(device)  # raises with the registered names
    raise TypeError(f"cannot resolve a DeviceSpec from {device!r}")


def from_torch_device(dev=None) -> DeviceSpec:
    """Derive an (uncalibrated) spec from a live torch device, beside the
    reference's ``from_jax_device``.

    A CUDA device takes the ``h100`` template (whatever the card: the port
    targets sm_90a), is named after ``torch.cuda.get_device_name`` and
    takes its capacity from ``get_device_properties().total_memory``; any
    other device takes ``host_cpu``.  ``dev=None`` is the current CUDA
    device when CUDA is available, else the CPU.  The spec is registered
    under its name, replacing an earlier derivation."""
    import torch

    if dev is None:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if torch.cuda.is_available() else torch.device("cpu"))
    dev = torch.device(dev)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        kind = torch.cuda.get_device_name(index)
        base = get_device("h100")
        hbm = float(torch.cuda.get_device_properties(index).total_memory)
        platform = "gpu"
    else:
        kind, base, hbm, platform = dev.type, get_device("host_cpu"), None, dev.type
    name = "torch_" + "".join(c if c.isalnum() else "_" for c in kind.lower())
    spec = replace(base, name=name, hbm_bytes=hbm or base.hbm_bytes,
                   meta={"platform": platform, "device_kind": kind})
    return register_device(spec, overwrite=True)


# ---------------------------------------------------------------------------
# Persistence (atomic, JSON or NPZ by extension — the fileio contract every
# on-disk artifact in this repo follows).
# ---------------------------------------------------------------------------


def save_device_spec(path: str, spec: DeviceSpec) -> None:
    from repro_torch.core.fileio import atomic_write_bytes, atomic_write_json

    if path.endswith(".npz"):
        import numpy as np

        arrays = {
            f: np.asarray(getattr(spec, f))
            for f in FITTED_FIELDS
            if f not in ("combine", "class_coeffs", "power_modes")
        }
        header = json.dumps({"name": spec.name, "combine": spec.combine,
                             "class_coeffs": spec.class_coeffs,
                             "power_modes": spec.power_modes,
                             "meta": spec.meta})
        arrays["header"] = np.frombuffer(header.encode(), dtype=np.uint8)
        atomic_write_bytes(path, lambda f: np.savez_compressed(f, **arrays),
                           suffix=".npz")
    else:
        atomic_write_json(path, spec.to_dict())


def load_device_spec(path: str) -> DeviceSpec:
    if path.endswith(".npz"):
        import numpy as np

        with np.load(path) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            d = {f: z[f].item() for f in FITTED_FIELDS
                 if f not in ("combine", "class_coeffs", "power_modes")
                 and f in z}
            d["alloc_granularity"] = int(d["alloc_granularity"])
            d["calibrated"] = bool(d["calibrated"])
            d.update(name=header["name"], combine=header["combine"],
                     class_coeffs=header.get("class_coeffs", {}),
                     power_modes=header.get("power_modes", {}),
                     meta=header.get("meta", {}))
            return DeviceSpec(**d)
    with open(path) as f:
        return DeviceSpec.from_dict(json.load(f))
