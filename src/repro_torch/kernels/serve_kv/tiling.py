"""Default block size of the paged serve KV pool (port of
``repro/kernels/serve_kv/tiling.py``).

This slice keeps ``shape_key`` and ``default``; the candidate list and
the cost model that rank block sizes come with the autotuner slice.
"""

from __future__ import annotations

__all__ = ["shape_key", "default"]


def shape_key(n_slots: int, max_len: int, n_kv_heads: int, head_dim: int,
              dtype, n_heads: int | None = None) -> dict:
    return {"B": int(n_slots), "L": int(max_len), "Hkv": int(n_kv_heads),
            "H": int(n_heads if n_heads is not None else n_kv_heads),
            "Dh": int(head_dim), "dtype": str(dtype).removeprefix("torch.")}


def default(shape: dict) -> dict:
    # one block spans a quarter of the window, capped at 256 tokens
    return {"block_size": max(16, min(shape["L"] // 4, 256))}
