"""Default launch configuration of paged decode attention (port of
``repro/kernels/paged_decode/tiling.py``).

This slice keeps ``shape_key`` and ``default``; the candidates and the
cost model come with the autotuner slice.
"""

from __future__ import annotations

from repro_torch.kernels.autotune import largest_dividing_block

__all__ = ["shape_key", "default"]


def shape_key(B, H, Hkv, Dh, NB, bs, dtype) -> dict:
    return {"B": int(B), "H": int(H), "Hkv": int(Hkv), "Dh": int(Dh),
            "NB": int(NB), "bs": int(bs),
            "dtype": str(dtype).removeprefix("torch.")}


def default(shape: dict) -> dict:
    # the kernel's own argument defaults: 128-wide tiles, no split
    return {"block_kv": largest_dividing_block(shape["bs"], 128),
            "n_splits": 1}
