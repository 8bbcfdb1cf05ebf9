"""Tiling search space + static cost model for the MM convolution (port of
``repro/kernels/conv_mm/tiling.py``).

``shape_key``, ``candidates``, ``default`` and ``cost`` are the
reference's (grid (N, O/block_o), VMEM holding the padded image, a weight
tile and the accumulator), so a TPU spec ranks them identically.  The
model is registered **without a runner**: the CUDA kernel's 64 × 64 tile
is fixed (see its source note), so ``block_o`` sets no tile on the card
and timing its candidates would time identical launches.  Under a CUDA
spec every config is legal (``smem_bytes`` is the fixed tile's), and
``ops.conv_mm`` does not consult the tuner.
"""

from __future__ import annotations

from repro_torch.kernels.autotune import (
    KernelCost,
    TilingModel,
    bytes_per_element,
    largest_dividing_block,
    register_tiling,
)

__all__ = ["shape_key", "candidates", "default", "cost"]

# csrc/conv_mm.cu: As[16][64 + 4] and Bs[16][64] f32, whatever block_o is
_SMEM_BYTES = 4 * (16 * (64 + 4) + 16 * 64)

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


def _geom(shape: dict):
    s, p = shape["stride"], shape["padding"]
    OH = 1 + (shape["H"] + 2 * p - shape["KH"]) // s
    OW = 1 + (shape["W"] + 2 * p - shape["KW"]) // s
    Hp, Wp = shape["H"] + 2 * p, shape["W"] + 2 * p
    return OH, OW, Hp, Wp


def cost(shape: dict, config: dict) -> KernelCost:
    N, C, O = shape["N"], shape["C"], shape["O"]
    KH, KW = shape["KH"], shape["KW"]
    bo = largest_dividing_block(O, config.get("block_o"))
    OH, OW, Hp, Wp = _geom(shape)
    bpe = bytes_per_element(shape["dtype"])
    n_bo = O // bo

    flops = 2.0 * N * OH * OW * KH * KW * C * O
    # x once per image (o innermost ⇒ revisit-elided), w per program, y once
    hbm = bpe * (N * Hp * Wp * C + N * KH * KW * C * O + N * OH * OW * O)
    vmem = (bpe * (Hp * Wp * C + KH * KW * C * bo + OH * OW * bo)
            + 4.0 * OH * OW * bo)  # f32 accumulator
    return KernelCost(
        op="conv_mm", op_class="conv", origin="kernel",
        flops=flops, hbm_bytes=hbm, vmem_bytes=vmem,
        n_steps=N * n_bo,
        mxu_min_dim=min(bo, C, OH * OW),
        smem_bytes=_SMEM_BYTES,
    )


register_tiling(TilingModel(
    name="conv_mm", candidates=candidates, cost=cost, default=default,
    runner=None,
), overwrite=True)
