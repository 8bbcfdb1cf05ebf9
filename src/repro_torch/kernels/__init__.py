"""Hand-written Hopper kernels (port of ``repro/kernels/``).

Each kernel package keeps ``kernel.py`` (the CUDA kernel's build, ctypes
binding and launch counter; sources under ``csrc/``), ``ref.py`` (the
plain PyTorch version), ``ops.py`` (the public wrapper: a CUDA tensor goes
to the kernel, a CPU tensor to the plain version) and ``tiling.py`` (the
search space and static cost model registered with
:mod:`repro_torch.kernels.autotune`, which picks launch configurations).
"""
