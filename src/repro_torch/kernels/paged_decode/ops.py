"""Public wrapper for paged decode attention (port of
``repro/kernels/paged_decode/ops.py``).

The device of the tensors picks the path: a CUDA tensor goes to the
Hopper kernel (``kernel.paged_decode_cuda``), which launches or raises; a
CPU tensor goes to the plain version (``ref.paged_decode_ref``).  There is
no other switch: the JAX package's ``impl=`` argument and its
``REPRO_PAGED_DECODE`` variable have no counterpart here.

``n_splits=None`` takes the tiling default (``tiling.default``; the
autotuner comes with a later slice).  ``block_kv`` is passed through: the
CUDA kernel sets no tile from it (see its source note).
"""

from __future__ import annotations

from . import tiling
from .kernel import paged_decode_cuda
from .ref import paged_decode_ref

__all__ = ["paged_decode_attention"]


def paged_decode_attention(q, k_pool, v_pool, block_table, cache_len, *,
                           scale=None, block_kv=None, n_splits=None):
    """q: (B, H, Dh); k/v_pool: (P, bs, Hkv, Dh); block_table: (B, NB)
    int32; cache_len: (B,) int32 → (B, H, Dh), attending logical
    positions ``<= cache_len[b]`` of each row's paged KV history."""
    if q.device.type == "cuda":
        if n_splits is None:
            B, H, Dh = q.shape
            n_splits = tiling.default(tiling.shape_key(
                B, H, k_pool.shape[2], Dh, block_table.shape[1],
                k_pool.shape[1], q.dtype))["n_splits"]
        return paged_decode_cuda(q, k_pool, v_pool, block_table, cache_len,
                                 scale=scale, block_kv=block_kv,
                                 n_splits=n_splits)
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, block_table, cache_len,
                                scale=scale)
    raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
