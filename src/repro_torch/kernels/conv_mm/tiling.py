"""Tiling search space + static cost model for the MM convolution (port of
``repro/kernels/conv_mm/tiling.py``).

``shape_key``, ``candidates``, ``default`` and ``cost`` are the
reference's (grid (N, O/block_o), VMEM holding the padded image, a weight
tile and the accumulator), so a TPU spec ranks them identically.  The
model is registered **without a runner**: the CUDA kernel's tile is not
``block_o`` but a fixed rule on the GEMM's shape (``conv_tile`` for f32,
``conv_tile_bf16`` for bf16), so
``block_o`` sets nothing on the card and timing its candidates would time
identical launches (and a runner inside the profiling grid would time
configs inside Φ).  Under a CUDA spec every config is legal
(``smem_bytes`` is the rule's tile's), and ``ops.conv_mm`` does not
consult the tuner.
"""

from __future__ import annotations

from repro_torch.kernels.autotune import (
    KernelCost,
    TilingModel,
    bytes_per_element,
    largest_dividing_block,
    register_tiling,
)

__all__ = ["shape_key", "candidates", "default", "cost", "conv_tile",
           "conv_tile_bf16", "tile_for", "smem_bytes", "NUM_SMS"]

# csrc/conv_mm.cu: both kernels take K in chunks of one 128-byte swizzle row
# (32 f32 or 64 bf16 values) through a ring of 4 stages, 1024-byte aligned
_ROW_BYTES, _STAGES, _ALIGN = 128, 4, 1024
NUM_SMS = 132                 # streaming multiprocessors of an H100 SXM


def conv_tile(M: int, O: int) -> tuple[int, int]:
    """(pixels, channels) of the f32 (3xTF32 ``wgmma``) kernel's block
    tile, one warpgroup per 64 pixels, for a GEMM of M output pixels and O
    output channels: 128 × 128 where O > 64 and the 64 × 64 grid has more
    blocks than the 132 SMs hold at once (two each), else 64 × 64.  A 128 ×
    128 block fills its SM alone (197,632 B of shared memory) and does
    about 1.17× the work of the two 64 × 64 blocks an SM holds in the same
    time, so 64 × 64 wins while its grid fits in one such wave and loses
    once it takes a second: on an H100 64 × 64 was the faster at every
    64-block grid of 128 × 128 (256 of 64 × 64) and 128 × 128 at every
    grid of 80-120 blocks among the profiled CNN's shapes.  The mixed tiles
    were never the fastest at any ResNet-50 shape at bs 128, so the f32
    kernel is built at 64 × 64 and 128 × 128 alone
    (``scripts/conv_mm_variants.py --f32``, PERF.md §6)."""
    if O > 64 and -(-M // 64) * -(-O // 64) > 2 * NUM_SMS:
        return 128, 128
    return 64, 64


def conv_tile_bf16(M: int, O: int) -> tuple[int, int]:
    """(pixels, channels) of the bf16 (``wgmma``) kernel's block tile, one
    warpgroup per 64 pixels: 64 channels where O ≤ 64, and 64 pixels
    where 128-pixel tiles would leave some of the 132 SMs without a block,
    so the bench's M 8192 × O 128 gets 128 blocks of 64 × 128 (not 64 of
    128 × 128).  On an H100 it beat every fixed tile over a ResNet-50
    forward at bs 128 (2.05–2.09 ms against 2.21–2.72;
    ``scripts/conv_mm_variants.py``, PERF.md §6)."""
    bn = 64 if O <= 64 else 128
    bm = 128 if -(-M // 128) * -(-O // bn) >= NUM_SMS else 64
    return bm, bn


def _is_bf16(dtype) -> bool:
    return str(dtype).removeprefix("torch.") == "bfloat16"


def tile_for(M: int, O: int, dtype) -> tuple[int, int]:
    """The tile the CUDA kernel launches for this GEMM and input type."""
    return conv_tile_bf16(M, O) if _is_bf16(dtype) else conv_tile(M, O)


def smem_bytes(bm: int, bn: int, dtype) -> int:
    """Shared memory of one block of the CUDA kernel: 1024 bytes of
    alignment slack and a ring of 4 stages, each a bm-row A tile and a
    bn-wide w tile of one 128-byte row a depth (bm × 64 and 64 × bn bf16,
    or bm × 32 and 32 × bn f32); for f32 also two K-major pairs of the w
    tile's hi and lo parts (bn × 32 f32 each).  The kernel computes the same
    number (``conv_mm_smem_bytes``)."""
    ring = _ALIGN + _STAGES * _ROW_BYTES * (bm + bn)
    return ring if _is_bf16(dtype) else ring + 4 * _ROW_BYTES * bn


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
    bm, bn = tile_for(N * OH * OW, O, shape["dtype"])
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
        smem_bytes=smem_bytes(bm, bn, shape["dtype"]),
    )


register_tiling(TilingModel(
    name="conv_mm", candidates=candidates, cost=cost, default=default,
    runner=None,
), overwrite=True)
