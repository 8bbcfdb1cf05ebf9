"""Launch-shape key and block candidates of the MM convolution (port of
``repro/kernels/conv_mm/tiling.py``).

This slice keeps ``shape_key``, ``candidates`` and ``default``; the cost
model and the tuner's registration come with the autotuner slice.  The
CUDA kernel's tile is fixed (see its source note), so ``block_o`` only
keeps the reference's launch signature.
"""

from __future__ import annotations

from repro_torch.kernels.autotune import largest_dividing_block

__all__ = ["shape_key", "candidates", "default"]

_BLOCK_SEEDS = (8, 16, 32, 64, 128, 256, 512)


def shape_key(x_shape, w_shape, *, stride: int, padding: int, dtype) -> dict:
    N, H, W, C = (int(d) for d in x_shape)
    KH, KW, _, O = (int(d) for d in w_shape)
    return {"N": N, "H": H, "W": W, "C": C, "KH": KH, "KW": KW, "O": O,
            "stride": int(stride), "padding": int(padding),
            "dtype": str(dtype).removeprefix("torch.")}


def candidates(shape: dict) -> list[dict]:
    O = shape["O"]
    blocks = {largest_dividing_block(O, b) for b in _BLOCK_SEEDS}
    blocks.add(O)
    return [{"block_o": b} for b in sorted(blocks)]


def default(shape: dict) -> dict:
    return {"block_o": min(shape["O"], 256)}
