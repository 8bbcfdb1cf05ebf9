"""Pipeline parallelism: a GPipe-style microbatched schedule over a
``pipe`` mesh axis (port of ``repro/distributed/pipeline_parallel.py``).

The schedule runs ``n_micro + n_stages − 1`` ticks; at each tick every
stage processes the microbatch it holds and sends its activation to its
successor.  Bubble fraction = (S−1)/(M+S−1) — reported by
``bubble_fraction`` and used by the layout accounting and the planner.

The reference expresses the schedule with ``shard_map`` and a
``collective-permute``; the port runs it on every rank of the ``pipe``
sub-group of a ``DeviceMesh``, with ``torch.distributed.batch_isend_irecv``
for the permute and a ``broadcast`` from the last stage for the
reference's closing ``all_gather(...)[n_stages - 1]``.  Validated against
the sequential stages by tests (four ``gloo`` ranks).
"""

from __future__ import annotations

import torch

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(stage_fn, stage_params, x_micro, mesh, *, axis: str = "pipe"):
    """Run ``stage_fn(params_stage, x)`` over pipeline stages.

    stage_params: a tensor, or a dict or list of them, stacked on the
    leading stage dim (each rank takes its own stage's row);  x_micro:
    (n_micro, micro_batch, ...) inputs, the same on every rank.  Returns
    (n_micro, micro_batch, ...) outputs (computed on the last stage,
    broadcast back to all stages), on every rank.
    """
    import torch.distributed as dist

    from repro_torch.convert import tree_map

    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    n_stages = len(ranks)
    stage = dist.get_rank(group)
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    params = tree_map(lambda a: a[stage], stage_params)

    mb = x_micro.shape[1:]
    buf = torch.zeros((n_micro,) + mb, dtype=x_micro.dtype, device=x_micro.device)
    carry = torch.zeros(mb, dtype=x_micro.dtype, device=x_micro.device)
    for t in range(ticks):
        # stage 0 ingests its own microbatch; others use the received carry
        x = x_micro[min(max(t, 0), n_micro - 1)] if stage == 0 else carry
        active = 0 <= t - stage < n_micro
        y = stage_fn(params, x) if active else carry
        # the last stage stores its completed microbatch
        m_done = t - (n_stages - 1)
        if stage == n_stages - 1 and 0 <= m_done < n_micro:
            buf[m_done] = y
        # permute activations to the next stage (stage 0 receives zeros)
        ops = []
        if stage < n_stages - 1:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), ranks[stage + 1], group))
        received = torch.zeros_like(carry)
        if stage > 0:
            ops.append(dist.P2POp(dist.irecv, received, ranks[stage - 1], group))
        for req in dist.batch_isend_irecv(ops) if ops else []:
            req.wait()
        carry = received
    # broadcast final outputs from the last stage to all stages
    dist.broadcast(buf, src=ranks[-1], group=group)
    return buf
