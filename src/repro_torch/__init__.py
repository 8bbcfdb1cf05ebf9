"""PyTorch/CUDA port of the ``repro`` package, for NVIDIA Hopper (sm_90a).

The JAX package ``src/repro/`` is the reference; this package mirrors its
layout file for file (``repro_torch/serve/kv_cache.py`` ports
``repro/serve/kv_cache.py``) and each module's docstring names the file it
ports.  It imports ``torch`` and ``numpy`` and nothing of ``jax`` or
``repro``.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``
and raises when CUDA is absent unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).  On a CUDA tensor each kernel
wrapper launches its hand-written kernel; its plain PyTorch version runs
only for tensors that lie on the CPU.
"""
