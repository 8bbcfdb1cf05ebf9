"""Hand-written Hopper kernels (port of ``repro/kernels/``).

Each kernel package keeps ``kernel.py`` (the CUDA kernel's build, ctypes
binding and launch counter; sources under ``csrc/``), ``ref.py`` (the
plain PyTorch version), ``ops.py`` (the public wrapper: a CUDA tensor goes
to the kernel, a CPU tensor to the plain version) and ``tiling.py`` (the
search space and static cost model registered with
:mod:`repro_torch.kernels.autotune`, which picks launch configurations).
The package re-exports the tuner's API, as the reference's does; importing
it builds no kernel and touches no CUDA state.
"""

from repro_torch.kernels.autotune import (
    KernelCost,
    KernelTuner,
    TilingModel,
    TuningCache,
    autotune_enabled,
    get_tiling,
    get_tuner,
    largest_dividing_block,
    list_tilings,
    register_tiling,
    roofline_seconds,
    set_tuner,
    tuned_config,
    vmem_ok,
)

__all__ = [
    "KernelCost",
    "KernelTuner",
    "TilingModel",
    "TuningCache",
    "autotune_enabled",
    "get_tiling",
    "get_tuner",
    "largest_dividing_block",
    "list_tilings",
    "register_tiling",
    "roofline_seconds",
    "set_tuner",
    "tuned_config",
    "vmem_ok",
]
