"""Block-size helpers (port of ``repro/kernels/autotune.py``).

This slice keeps only ``largest_dividing_block`` and ``bytes_per_element``;
the tuner itself (``KernelTuner``, ``TuningCache``, the cost models) comes
with a later slice, so every caller here uses the tiling defaults.
"""

from __future__ import annotations

__all__ = ["largest_dividing_block", "bytes_per_element"]

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
