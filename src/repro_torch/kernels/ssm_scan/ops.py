"""SSD op: the intra-chunk kernel + the inter-chunk recurrence in PyTorch
(port of ``repro/kernels/ssm_scan/ops.py``).

The device of the tensors picks the intra-chunk path: a CUDA tensor goes
to the Hopper kernel (``kernel.ssd_chunk_cuda``), which launches or
raises; a CPU tensor goes to its plain version (``ref.ssd_chunk_ref``).
Around it, as in the reference's ``_ssd_jit``, the sequential recurrence
over the per-chunk states (its ``lax.scan``, here a Python loop over
chunks) and the ``y_off`` correction run in PyTorch, with TF32 off.
(Off the TPU the reference's op runs ``ssd_ref`` instead; the port keeps
one path and holds it against ``ssd_ref`` in the tests.)

``chunk=None`` consults the process autotuner; an explicit chunk always
wins, snapped to the largest divisor of S ≤ the request.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.autotune import largest_dividing_block, tuned_config

from . import tiling
from .kernel import ssd_chunk_cuda
from .ref import ssd_chunk_ref

__all__ = ["ssd"]


@contextlib.contextmanager
def _fp32_matmuls():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def ssd(xh, a, Bm, Cm, *, chunk=None, initial_state=None):
    """Full SSD: y (B,S,H,P) in xh's dtype and final state (B,H,P,N) f32."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    if chunk is None:
        shape = tiling.shape_key(xh.shape, N, dtype=xh.dtype)
        chunk = tuned_config("ssm_scan", shape,
                             tiling.default(shape)).get("chunk", 128)
    chunk = largest_dividing_block(S, chunk)
    nc = S // chunk
    if xh.device.type == "cuda":
        y_diag, states, chunk_decay, cum = ssd_chunk_cuda(xh, a, Bm, Cm,
                                                          chunk=chunk)
    elif xh.device.type == "cpu":
        y_diag, states, chunk_decay, cum = ssd_chunk_ref(xh, a, Bm, Cm,
                                                         chunk=chunk)
    else:
        raise ValueError(f"ssd: unsupported device {xh.device}")

    with _fp32_matmuls():
        # inter-chunk recurrence over (B, nc, H, N, P) states
        carry = (initial_state.float().transpose(-1, -2)
                 if initial_state is not None
                 else torch.zeros(B, H, N, P, device=xh.device))
        prev = []
        for i in range(nc):
            prev.append(carry)          # the state entering chunk i
            carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
        prev = torch.stack(prev, dim=1)                       # (B,nc,H,N,P)
        # y_off[b,c,l,h,p] = exp(cum) · C_l · prev_state
        Cc = Cm.reshape(B, nc, chunk, N).float()
        y_off = torch.einsum("bcln,bchnp,bchl->bclhp", Cc, prev, torch.exp(cum))
        y = y_diag.float() + y_off.reshape(B, S, H, P)
    return y.to(xh.dtype), carry.transpose(-1, -2)
