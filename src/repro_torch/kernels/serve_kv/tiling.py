"""Tiling search space + static cost model for the paged serve KV cache
(port of ``repro/kernels/serve_kv/tiling.py``; a cost model only, no
runner).

``block_size`` is the one knob.  It is resolved jointly with the
``paged_decode`` kernel that consumes the pool: each candidate ``bs`` is
priced by the paged_decode cost model at its own default config for a
pool of ``bs``-sized blocks spanning the context window, plus the pool's
own per-step scatter write and block-table re-read.  Costs are modelled
at the expected steady-state occupancy ``max_len/2``.  Under a CUDA spec
the shared-memory budget is the paged_decode kernel's, which no pool
block size changes.
"""

from __future__ import annotations

from repro_torch.kernels.autotune import (
    KernelCost,
    TilingModel,
    bytes_per_element,
    register_tiling,
)
from repro_torch.kernels.paged_decode import tiling as pd_tiling

__all__ = ["shape_key", "candidates", "cost", "default"]

_BLOCK_SEEDS = (16, 32, 64, 128, 256, 512)


def shape_key(n_slots: int, max_len: int, n_kv_heads: int, head_dim: int,
              dtype, n_heads: int | None = None) -> dict:
    return {"B": int(n_slots), "L": int(max_len), "Hkv": int(n_kv_heads),
            "H": int(n_heads if n_heads is not None else n_kv_heads),
            "Dh": int(head_dim), "dtype": str(dtype).removeprefix("torch.")}


def candidates(shape: dict) -> list[dict]:
    cands = [{"block_size": b} for b in _BLOCK_SEEDS if b <= shape["L"]]
    return cands or [{"block_size": shape["L"]}]


def default(shape: dict) -> dict:
    # one block spans a quarter of the window, capped at 256 tokens
    return {"block_size": max(16, min(shape["L"] // 4, 256))}


def cost(shape: dict, config: dict) -> KernelCost:
    B, L = shape["B"], shape["L"]
    H = shape.get("H", shape["Hkv"])
    Hkv, Dh = shape["Hkv"], shape["Dh"]
    bs = max(1, min(int(config.get("block_size", L)), L))
    bpe = bytes_per_element(shape["dtype"])
    NB = max(1, -(-L // bs))           # full-window table width

    # Joint resolution: price this pool layout through the decode
    # kernel's own cost model at the kernel's default config for bs.
    pd_shape = pd_tiling.shape_key(B, H, Hkv, Dh, NB, bs, shape["dtype"])
    pd = pd_tiling.cost(pd_shape, pd_tiling.default(pd_shape))

    # + the pool's own per-step work: scatter the step's K/V row in,
    # re-read the block tables
    hbm = pd.hbm_bytes + bpe * 2.0 * B * Hkv * Dh + 4.0 * B * NB
    return KernelCost(
        op="serve_kv", op_class="matmul", origin="kernel",
        flops=pd.flops, hbm_bytes=hbm, vmem_bytes=pd.vmem_bytes,
        n_steps=pd.n_steps,
        mxu_min_dim=pd.mxu_min_dim,
        smem_bytes=pd.smem_bytes,
    )


register_tiling(TilingModel(
    name="serve_kv", candidates=candidates, cost=cost, default=default,
    runner=None,
), overwrite=True)
