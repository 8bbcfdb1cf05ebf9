"""Tiling search space + static cost model for MoE capacity dispatch (port
of ``repro/kernels/moe_dispatch/tiling.py``; a cost model only, with no
runner and no kernel).

Not a kernel — the GShard-style dispatch in ``models/layers.py``
(``moe_block``, which reads its knobs through ``_tuned_moe_dispatch``)
is plain tensor code — but its two free knobs are exactly a
tiling problem, so it goes through the same
:class:`~repro_torch.kernels.autotune.KernelTuner` candidate/cost-model
interface as the kernels:

* ``groups`` — token groups vmapped over the (data-sharded) batch axis.
  Fewer groups amortise the per-8 capacity rounding and the per-(group ×
  expert) program overhead; more groups shrink the per-group working set
  (capacity ∝ 1/groups) and keep routing device-local on wider meshes.
* ``capacity_factor`` — expert buffer slack.  Candidates never go BELOW
  the architecture's configured factor: a smaller buffer drops more
  tokens, which changes model quality, and the tuner must never trade
  accuracy for speed.  Larger factors are explored for the timed path
  (padding can win on real hardware when it aligns the expert matmul).

Compute overhead over the ideal is exactly ``capacity · rounding``, which
is what ``cost`` charges; the working set is the per-(group, expert)
expert-matmul operand block.
"""

from __future__ import annotations

import math

from repro_torch.kernels.autotune import (
    KernelCost,
    TilingModel,
    bytes_per_element,
    largest_dividing_block,
    register_tiling,
)

__all__ = ["shape_key", "candidates", "cost", "default"]

_GROUP_SEEDS = (1, 2, 4, 8, 16, 32, 64)
_FACTOR_SLACK = (1.0, 1.25, 1.5)


def _capacity(tokens: int, n_experts: int, k: int, factor: float) -> int:
    """Per-expert slot count — MUST match the reference's
    ``models.layers.moe_capacity`` (multiple of 8, floor 8); asserted in
    tests."""
    c = int(math.ceil(tokens * k / n_experts * factor))
    return max(8, -(-c // 8) * 8)


def shape_key(B: int, S: int, D: int, E: int, K: int, F: int,
              capacity_factor: float, dtype) -> dict:
    return {"B": int(B), "S": int(S), "D": int(D), "E": int(E), "K": int(K),
            "F": int(F), "cf": float(capacity_factor),
            "dtype": str(dtype).removeprefix("torch.")}


def default(shape: dict) -> dict:
    # the hand-picked constants moe_block used before autotuning
    return {"groups": math.gcd(shape["B"], 32),
            "capacity_factor": shape["cf"]}


def candidates(shape: dict) -> list[dict]:
    groups = sorted({largest_dividing_block(shape["B"], g)
                     for g in _GROUP_SEEDS})
    factors = sorted({round(shape["cf"] * s, 4) for s in _FACTOR_SLACK})
    return [{"groups": g, "capacity_factor": f}
            for g in groups for f in factors]


def cost(shape: dict, config: dict) -> KernelCost:
    B, S, D = shape["B"], shape["S"], shape["D"]
    E, K, F = shape["E"], shape["K"], shape["F"]
    G = largest_dividing_block(B, config.get("groups"))
    f = max(float(config.get("capacity_factor", shape["cf"])), shape["cf"])
    bpe = bytes_per_element(shape["dtype"])

    Tg = (B // G) * S
    C = _capacity(Tg, E, K, f)

    router = 2.0 * B * S * D * E                     # logits einsum (f32)
    experts = 6.0 * G * E * C * D * F                # gate/up/down matmuls
    sort = B * S * K * max(math.log2(max(Tg * K, 2)), 1.0)
    flops = router + experts + sort

    buf = G * E * C                                  # expert slots total
    hbm = bpe * (
        2.0 * B * S * D                              # x in, out
        + 3.0 * buf * D                              # dispatch buf w+r, out_buf
        + 2.0 * buf * F                              # hidden w+r
        + 3.0 * E * D * F                            # expert weights
    ) + 4.0 * B * S * E                              # f32 router logits
    # Per-(group, expert) program working set: one expert's operand block.
    vmem = bpe * (C * D + C * F + D * F)
    return KernelCost(
        op="moe_dispatch", op_class="matmul", origin="kernel",
        flops=flops, hbm_bytes=hbm, vmem_bytes=vmem,
        n_steps=G * E,
        mxu_min_dim=min(C, D, F),
        smem_bytes=0.0,              # no CUDA kernel: no shared-memory budget
    )


register_tiling(TilingModel(
    name="moe_dispatch", candidates=candidates, cost=cost, default=default,
    runner=None,
), overwrite=True)
