"""Tiling search space + static cost model for paged decode attention
(port of ``repro/kernels/paged_decode/tiling.py``).

``shape_key``, ``candidates``, ``default``, ``cost`` and ``gather_cost``
are the reference's: costs at the pool's steady state (rows half full,
``ctx = NB·bs/2``) over ``block_kv`` (inner chunk) × ``n_splits``
(flash-decode KV-axis parallelism), so a TPU spec ranks them identically.
``_MEGACORE`` is the reference's TPU constant (two TensorCores sharing
HBM); it stays, since it is part of the cost every spec ranks by.

On the card (``csrc/paged_decode.cu``), the tuner times each config
through ``_runner``: ``n_splits`` cuts the KV axis into that many blocks
of the grid, and ``block_kv`` is the kernels' token tile, streamed through
a ring of three shared-memory stages in the pool's type (bf16 q and pools
run the bf16 tensor-core kernel, every other pair the 3xTF32 one, both on
the same ring).  ``cost`` reports that ring as ``smem_bytes``, so under a
CUDA spec the tuner rejects a tile the ring cannot hold: 256 tokens at Dh
128 in bf16, 128 at Dh 128 and 256 at Dh 64 in f32.  The shape key holds
q's type, which the tuner takes for the pools' too.
"""

from __future__ import annotations

from repro_torch.kernels.autotune import (
    KernelCost,
    TilingModel,
    bytes_per_element,
    largest_dividing_block,
    register_tiling,
)

__all__ = ["shape_key", "candidates", "cost", "default", "gather_cost",
           "smem_bytes"]

_BLOCK_SEEDS = (16, 32, 64, 128, 256, 512)
_SPLIT_SEEDS = (1, 2, 4, 8)

# TensorCores per chip sharing HBM: n_splits > 1 buys parallel grid-step
# sequencing up to this factor (crude — models MegaCore as perfectly
# splitting the sequenced-step chain, nothing else).
_MEGACORE = 2


def shape_key(B, H, Hkv, Dh, NB, bs, dtype) -> dict:
    return {"B": int(B), "H": int(H), "Hkv": int(Hkv), "Dh": int(Dh),
            "NB": int(NB), "bs": int(bs),
            "dtype": str(dtype).removeprefix("torch.")}


_STAGES = 3          # csrc/paged_decode.cu: kStages


def smem_bytes(Dh: int, block_kv: int, kv_dtype) -> int:
    """Shared memory of one block of the CUDA kernels at this tile; the
    source computes the same number (``paged_decode_smem_bytes``): a ring of
    3 stages of K and V tiles of ``block_kv`` tokens rounded up to a power
    of two >= 16, in the pools' type ``kv_dtype``."""
    tile = 16
    while tile < block_kv:
        tile *= 2
    return _STAGES * 2 * tile * Dh * bytes_per_element(kv_dtype)


def candidates(shape: dict) -> list[dict]:
    bs, NB = shape["bs"], shape["NB"]
    bkvs = sorted({largest_dividing_block(bs, b) for b in _BLOCK_SEEDS} | {bs})
    splits = sorted({min(s, NB) for s in _SPLIT_SEEDS})
    return [{"block_kv": bkv, "n_splits": ns} for bkv in bkvs for ns in splits]


def default(shape: dict) -> dict:
    # the kernel's own argument defaults: 128-wide chunks, no split
    return {"block_kv": largest_dividing_block(shape["bs"], 128),
            "n_splits": 1}


def _steady_live_blocks(shape: dict) -> int:
    # rows half full: ctx = NB·bs/2 valid positions ⇒ live = ctx//bs + 1
    return (shape["NB"] * shape["bs"] // 2) // shape["bs"] + 1


def cost(shape: dict, config: dict) -> KernelCost:
    B, H, Hkv, Dh = shape["B"], shape["H"], shape["Hkv"], shape["Dh"]
    NB, bs = shape["NB"], shape["bs"]
    rep = H // Hkv
    bkv = largest_dividing_block(bs, config.get("block_kv"))
    ns = max(1, min(int(config.get("n_splits", 1)), NB))
    bpe = bytes_per_element(shape["dtype"])
    live = _steady_live_blocks(shape)

    # qk^T + pv over live keys only (early exit) for every query head
    flops = 4.0 * B * H * live * bs * Dh
    # touched KV (live blocks, once per kv head via revisit elision) +
    # q in / combined o out + f32 split partials (acc, m, l) written by
    # the kernel and re-read by the combine + the int32 table/cache_len
    hbm = (bpe * 2.0 * B * Hkv * live * bs * Dh
           + bpe * 2.0 * B * H * Dh
           + 4.0 * 2.0 * B * H * ns * (Dh + 2)
           + 4.0 * (B * NB + B))
    vmem = (bpe * (rep * Dh + 2 * bs * Dh)      # q block + k/v pool blocks
            + 4.0 * rep * Dh * 2                # f32 acc scratch + o partial
            + 4.0 * rep * bkv                   # f32 score/prob chunk
            + 4.0 * 2 * rep * 128)              # m/l lane-padded stats
    # Sequenced chain per (b, h): live grid steps (dead ones are clamped
    # revisits — free) × loop trips; splits run on parallel cores.
    npb = -(-NB // ns)
    live_steps = min(live, npb * ns)
    n_steps = B * Hkv * live_steps * (1 + bs // bkv) / min(ns, _MEGACORE)
    return KernelCost(
        op="paged_decode", op_class="matmul", origin="kernel",
        flops=flops, hbm_bytes=hbm, vmem_bytes=vmem,
        n_steps=int(max(n_steps, 1)),
        mxu_min_dim=min(rep, bkv, Dh),
        smem_bytes=smem_bytes(Dh, bkv, shape["dtype"]),
    )


def gather_cost(shape: dict) -> KernelCost:
    """The XLA fallback at the same shape: materialise the full
    ``(B, NB·bs)`` logical K and V views (pool read + gathered write),
    then dense attention re-reads them — cache_len-oblivious."""
    B, H, Hkv, Dh = shape["B"], shape["H"], shape["Hkv"], shape["Dh"]
    L = shape["NB"] * shape["bs"]
    bpe = bytes_per_element(shape["dtype"])
    flops = 4.0 * B * H * L * Dh                     # full width, no exit
    hbm = (bpe * 2.0 * B * Hkv * L * Dh * 3.0        # gather r+w, attn read
           + bpe * 2.0 * B * H * Dh)
    return KernelCost(
        op="paged_decode_gather", op_class="matmul", origin="fallback",
        flops=flops, hbm_bytes=hbm, vmem_bytes=0.0,
        n_steps=1, mxu_min_dim=min(H // Hkv, Dh),
    )


def _runner(shape: dict, config: dict):
    """Random q and pools on the card (seed 0), the table in pool order,
    rows at the steady state (cache_len = NB·bs/2), one launch per call."""
    import torch

    from .ops import paged_decode_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, Hkv, Dh = shape["B"], shape["Hkv"], shape["Dh"]
    NB, bs = shape["NB"], shape["bs"]
    P = B * NB + 1
    dtype = getattr(torch, shape["dtype"])
    q = torch.randn(B, shape["H"], Dh, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(P, bs, Hkv, Dh, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(P, bs, Hkv, Dh, generator=gen, device="cuda").to(dtype)
    bt = (1 + torch.arange(B * NB, device="cuda", dtype=torch.int32)).view(B, NB)
    cl = torch.full((B,), NB * bs // 2, dtype=torch.int32, device="cuda")
    bkv, ns = config["block_kv"], config["n_splits"]
    return lambda: paged_decode_attention(
        q, kp, vp, bt, cl, block_kv=bkv, n_splits=ns)


register_tiling(TilingModel(
    name="paged_decode", candidates=candidates, cost=cost, default=default,
    runner=_runner,
), overwrite=True)
