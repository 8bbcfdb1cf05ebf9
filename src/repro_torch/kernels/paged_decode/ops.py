"""Public wrapper for paged decode attention (port of
``repro/kernels/paged_decode/ops.py``).

The device of the tensors picks the path: a CUDA tensor goes to the
Hopper kernel (``kernel.paged_decode_cuda``), which launches or raises; a
CPU tensor goes to the plain version (``ref.paged_decode_ref``).  There is
no other switch: the JAX package's ``impl=`` argument and its
``REPRO_PAGED_DECODE`` variable have no counterpart here.

``block_kv=None`` / ``n_splits=None`` consult the process autotuner for
this launch shape, as in the reference (``ops.py:63``); explicit values
always win.  ``block_kv`` is the token tile of the tensor-core kernel
that bf16 q and pools run (see its source note).
"""

from __future__ import annotations

from repro_torch.kernels.autotune import tuned_config

from . import tiling
from .kernel import paged_decode_cuda
from .ref import paged_decode_ref

__all__ = ["paged_decode_attention"]


def paged_decode_attention(q, k_pool, v_pool, block_table, cache_len, *,
                           scale=None, block_kv=None, n_splits=None):
    """q: (B, H, Dh); k/v_pool: (P, bs, Hkv, Dh); block_table: (B, NB)
    int32; cache_len: (B,) int32 → (B, H, Dh), attending logical
    positions ``<= cache_len[b]`` of each row's paged KV history."""
    if block_kv is None or n_splits is None:
        B, H, Dh = q.shape
        shape = tiling.shape_key(B, H, k_pool.shape[2], Dh,
                                 block_table.shape[1], k_pool.shape[1],
                                 q.dtype)
        tuned = tuned_config("paged_decode", shape, tiling.default(shape))
        block_kv = block_kv if block_kv is not None else tuned.get(
            "block_kv", 128)
        n_splits = n_splits if n_splits is not None else tuned.get(
            "n_splits", 1)
    if q.device.type == "cuda":
        return paged_decode_cuda(q, k_pool, v_pool, block_table, cache_len,
                                 scale=scale, block_kv=block_kv,
                                 n_splits=n_splits)
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, block_table, cache_len,
                                scale=scale)
    raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
