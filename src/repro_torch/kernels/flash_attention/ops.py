"""Public wrapper for flash attention (port of
``repro/kernels/flash_attention/ops.py``).

The device of the tensors picks the path: a CUDA tensor goes to the Hopper
kernel (``kernel.flash_attention_cuda``), which launches or raises; a CPU
tensor goes to the plain version (``ref.attention_ref``).  The reference's
``interpret=`` has no counterpart.

``block_q=None`` / ``block_k=None`` consult the process autotuner
(``repro_torch.kernels.autotune.tuned_config``) for this launch shape, as
in the reference; explicit blocks always win.
"""

from __future__ import annotations

from repro_torch.kernels.autotune import tuned_config

from . import tiling
from .kernel import flash_attention_cuda
from .ref import attention_ref

__all__ = ["flash_attention"]


def flash_attention(q, k, v, *, causal=True, block_q=None, block_k=None,
                    q_offset=0):
    """q: (B, H, Sq, Dh); k, v: (B, Hkv, Sk, Dh) → (B, H, Sq, Dh)."""
    if block_q is None or block_k is None:
        shape = tiling.shape_key(q.shape, k.shape, causal=causal,
                                 dtype=q.dtype)
        tuned = tuned_config("flash_attention", shape, tiling.default(shape))
        block_q = block_q if block_q is not None else tuned.get("block_q", 512)
        block_k = block_k if block_k is not None else tuned.get("block_k", 512)
    if q.device.type == "cuda":
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    block_q=block_q, block_k=block_k,
                                    q_offset=q_offset)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
