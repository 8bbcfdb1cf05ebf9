"""Tiling search space + static cost model for flash attention (port of
``repro/kernels/flash_attention/tiling.py``).

``shape_key``, ``candidates``, ``default`` and ``cost``'s flops, HBM
bytes, VMEM working set and step count are the reference's, so a TPU spec
ranks them identically.  On top, ``cost`` reports ``smem_bytes``: the
shared memory one block of the port's CUDA kernel (``csrc/
flash_attention.cu``) takes at this config and dtype, which is what a CUDA
spec budgets.  The tuner's two knobs map onto that kernel as follows:

* ``block_q`` — query rows per block (grid = B × H × Sq/block_q); the
  block walks them in 128-row passes (both dtypes), so it sets
  parallelism and K/V reuse, not shared memory;
* ``block_k`` — the K/V tile of one ring stage, capped so that the ring
  fits beside the Q pass: for bf16 ``kv_tile(block_k)`` = 64 keys for
  block_k ≤ 64, else 128; for f32 (3xTF32 on the tensor cores)
  ``f32_kv_tile(Dh, block_k)`` = 32 keys for block_k ≤ 32, else 64 (the
  f32 ring of two stages of K and V and K's lo part fit beside the
  128-row f32 Q pass at every head dim, at Dh 128 to the byte).  So every
  config fits (``smem_bytes`` ≤ 232,448 B) and every config a CUDA-spec
  tuner can return launches.
"""

from __future__ import annotations

from repro_torch.kernels.autotune import (
    SMEM_BYTES_PER_BLOCK,
    KernelCost,
    TilingModel,
    bytes_per_element,
    largest_dividing_block,
    register_tiling,
)

__all__ = ["shape_key", "candidates", "cost", "default", "smem_bytes",
           "kv_tile", "f32_kv_tile"]

_BLOCK_SEEDS = (64, 128, 256, 512, 1024)

# The CUDA kernel's own tiles (csrc/flash_attention.cu).
_F32_ROWS, _F32_STAGES = 128, 2        # f32: rows per pass, K/V ring depth
_BF16_ROWS, _BF16_STAGES = 128, 2      # bf16: rows per pass, K/V ring depth


def kv_tile(block_k: int) -> int:
    """Keys in one ring stage of the bf16 kernel (``kv_tile`` there)."""
    return 64 if block_k <= 64 else 128


def _f32_bytes(Dh: int, tile: int) -> int:
    return 1024 + 4 * (_F32_ROWS * Dh + (_F32_STAGES + 1) * tile * Dh
                       + _F32_STAGES * tile * (Dh + 4))


def f32_kv_tile(Dh: int, block_k: int) -> int:
    """Keys in one ring stage of the f32 kernel (``f32_kv_tile`` there)."""
    return 64 if block_k > 32 and _f32_bytes(Dh, 64) <= SMEM_BYTES_PER_BLOCK else 32


def smem_bytes(Dh: int, block_k: int, dtype) -> int:
    """Shared memory of one block of the CUDA kernel, in bytes.

    bf16: 1024 B of alignment slack for the swizzled tiles, the Q pass
    (128 × Dh), two stages of K and V tiles (``kv_tile(block_k)`` × Dh),
    all bf16, and 128 B of mbarriers.  f32: 1024 B of alignment slack, the
    Q pass (128 × Dh), two stages of K tiles and K's lo part (three tiles of
    ``f32_kv_tile(Dh, block_k)`` × Dh, swizzled for ``wgmma``) and two
    stages of V tiles (rows padded to Dh + 4), all f32.  The kernel
    computes the same number (``flash_attention_smem_bytes``)."""
    if str(dtype).removeprefix("torch.") == "bfloat16":
        return (1024 + 2 * (_BF16_ROWS * Dh + 2 * _BF16_STAGES * kv_tile(block_k) * Dh)
                + 128)
    return _f32_bytes(Dh, f32_kv_tile(Dh, block_k))


def shape_key(q_shape, k_shape, *, causal: bool, dtype) -> dict:
    B, H, Sq, Dh = (int(d) for d in q_shape)
    Hkv, Sk = int(k_shape[1]), int(k_shape[2])
    return {"B": B, "H": H, "Hkv": Hkv, "Sq": Sq, "Sk": Sk, "Dh": Dh,
            "causal": bool(causal), "dtype": str(dtype).removeprefix("torch.")}


def _snap(n: int) -> list[int]:
    return sorted({largest_dividing_block(n, b) for b in _BLOCK_SEEDS} | {n})


def candidates(shape: dict) -> list[dict]:
    return [{"block_q": bq, "block_k": bk}
            for bq in _snap(shape["Sq"]) for bk in _snap(shape["Sk"])]


def default(shape: dict) -> dict:
    # the kernel's hand-picked constants, after its own min(·, S) clamp
    return {"block_q": largest_dividing_block(shape["Sq"], 512),
            "block_k": largest_dividing_block(shape["Sk"], 512)}


def cost(shape: dict, config: dict) -> KernelCost:
    B, H, Hkv = shape["B"], shape["H"], shape["Hkv"]
    Sq, Sk, Dh = shape["Sq"], shape["Sk"], shape["Dh"]
    bq = largest_dividing_block(Sq, config.get("block_q"))
    bk = largest_dividing_block(Sk, config.get("block_k"))
    bpe = bytes_per_element(shape["dtype"])

    frac = 0.5 if shape["causal"] else 1.0  # masked-out score work skipped
    flops = 4.0 * B * H * Sq * Sk * Dh * frac
    # q/o once; K/V once per kv head
    hbm = bpe * (2.0 * B * H * Sq * Dh + 2.0 * B * Hkv * Sk * Dh)
    vmem = (bpe * (bq * Dh + 2 * Sk * Dh + bq * Dh)   # q, K/V, o blocks
            + 4.0 * bq * Dh                            # f32 accumulator
            + 4.0 * bq * bk                            # f32 score/prob tile
            + 4.0 * 3 * bq)                            # m/l running stats
    n_programs = B * H * (Sq // bq)
    return KernelCost(
        op="flash_attention", op_class="matmul", origin="kernel",
        flops=flops, hbm_bytes=hbm, vmem_bytes=vmem,
        n_steps=n_programs * (1 + Sk // bk),
        mxu_min_dim=min(bq, bk, Dh),
        smem_bytes=smem_bytes(Dh, bk, shape["dtype"]),
    )


def _runner(shape: dict, config: dict):
    """Random q/k/v on the card (seed 0) and one ``ops.flash_attention``
    launch per call at this config."""
    import torch

    from .ops import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = getattr(torch, shape["dtype"])

    def draw(*s):
        return torch.randn(*s, generator=gen, device="cuda").to(dtype)

    q = draw(shape["B"], shape["H"], shape["Sq"], shape["Dh"])
    k = draw(shape["B"], shape["Hkv"], shape["Sk"], shape["Dh"])
    v = draw(shape["B"], shape["Hkv"], shape["Sk"], shape["Dh"])
    bq, bk = config["block_q"], config["block_k"]
    return lambda: flash_attention(q, k, v, causal=shape["causal"],
                                   block_q=bq, block_k=bk)


register_tiling(TilingModel(
    name="flash_attention", candidates=candidates, cost=cost, default=default,
    runner=_runner,
), overwrite=True)
