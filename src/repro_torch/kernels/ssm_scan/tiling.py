"""Tiling search space + static cost model for the SSD (Mamba-2) kernel
(port of ``repro/kernels/ssm_scan/tiling.py``).

The chunk length is a genuine optimum: intra-chunk compute is quadratic in
``chunk`` (the (l, l) decay/score tiles), while the inter-chunk state
traffic and sequential recurrence shrink as 1/chunk.  ``shape_key``,
``candidates``, ``default`` and ``cost``'s flops, HBM bytes, VMEM working
set and step count are the reference's, so a TPU spec ranks them
identically.

On top, ``cost`` reports ``smem_bytes``: the shared memory one block of
the port's CUDA kernel (``csrc/ssd_chunk.cu``) takes for a chunk of ``l``
steps — the chunk's B and C B^T held whole in f32, the cum and decay
weights of its group of heads, and C (while C B^T is built) or two
buffers of x, rows padded against bank conflicts.  The kernel does not
sub-tile the chunk, so under a CUDA spec a chunk that does not fit
(l = 256 and up at N = 128, P = 64) is rejected by the tuner and every
chunk it can return launches.
"""

from __future__ import annotations

from repro_torch.kernels.autotune import (
    KernelCost,
    TilingModel,
    bytes_per_element,
    largest_dividing_block,
    register_tiling,
)

__all__ = ["shape_key", "candidates", "cost", "default", "smem_bytes"]

_CHUNK_SEEDS = (16, 32, 64, 128, 256, 512)
_GROUP = 6           # csrc/ssd_chunk.cu: kGroup, heads per block


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(l: int, N: int, P: int) -> int:
    """Shared memory of one block of the CUDA kernel at chunk ``l``; the
    kernel computes the same number (``ssd_chunk_smem_bytes``): f32 rows of
    B (lp x (Np + 8)) and C B^T (lp x (lp + 4)), cum and weights of the
    block's heads, and C (lp x (Np + 4)) or two x buffers (lp x (Pp + 8)) in one
    region, with lp, Np = l, N rounded up to 16 and Pp = P to 32."""
    lp, Np, Pp = _round_up(l, 16), _round_up(N, 16), _round_up(P, 32)
    return 4 * (lp * (Np + 8) + lp * (lp + 4) + 2 * _GROUP * lp
                + max(lp * (Np + 4), 2 * lp * (Pp + 8)))


def shape_key(xh_shape, n_state: int, *, dtype) -> dict:
    B, S, H, P = (int(d) for d in xh_shape)
    return {"B": B, "S": S, "H": H, "P": P, "N": int(n_state),
            "dtype": str(dtype).removeprefix("torch.")}


def candidates(shape: dict) -> list[dict]:
    S = shape["S"]
    chunks = {largest_dividing_block(S, c) for c in _CHUNK_SEEDS} | {S}
    return [{"chunk": c} for c in sorted(chunks)]


def default(shape: dict) -> dict:
    return {"chunk": largest_dividing_block(shape["S"], 128)}


def cost(shape: dict, config: dict) -> KernelCost:
    B, S, H, P, N = (shape[k] for k in ("B", "S", "H", "P", "N"))
    l = largest_dividing_block(S, config.get("chunk"))
    nc = S // l
    bpe = bytes_per_element(shape["dtype"])

    # intra-chunk matmuls (C·Bᵀ and (s∘L)·x are l×l) + state build/apply
    flops = 2.0 * B * S * H * (l * (N + P) + 2.0 * N * P)
    hbm = (bpe * (2.0 * B * S * H * P)        # x in, y_diag out
           + 4.0 * 2 * B * S * H              # a in (f32 view), cum out
           + bpe * 2.0 * B * S * N            # B/C once per (b, chunk)
           + 4.0 * B * nc * H * (N * P + 1))  # states + chunk decay out
    vmem = (bpe * (l * P + 2 * l * N)         # x, B/C blocks
            + 4.0 * (2 * l * l               # L decay + score tiles (f32)
                     + l * P                  # y accumulator
                     + N * P + 2 * l))        # state tile, cum/decay vectors
    return KernelCost(
        op="ssm_scan", op_class="matmul", origin="kernel",
        flops=flops, hbm_bytes=hbm, vmem_bytes=vmem,
        n_steps=B * nc * H + nc,              # grid programs + scan steps
        mxu_min_dim=min(l, N, P),
        smem_bytes=smem_bytes(l, N, P),
    )


def _runner(shape: dict, config: dict):
    """Random inputs on the card (seed 0; a = -0.1·|N(0, 1)|, B reused as
    C, as the reference's runner does) and one ``ops.ssd`` per call."""
    import torch

    from .ops import ssd

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, P, N = (shape[k] for k in ("B", "S", "H", "P", "N"))
    dtype = getattr(torch, shape["dtype"])
    xh = torch.randn(B, S, H, P, generator=gen, device="cuda").to(dtype)
    a = -torch.randn(B, S, H, generator=gen, device="cuda").abs() * 0.1
    Bm = torch.randn(B, S, N, generator=gen, device="cuda").to(dtype)
    ch = config["chunk"]
    return lambda: ssd(xh, a, Bm, Bm, chunk=ch)[0]


register_tiling(TilingModel(
    name="ssm_scan", candidates=candidates, cost=cost, default=default,
    runner=_runner,
), overwrite=True)
