"""Paged single-query decode attention — the Hopper CUDA kernel's build,
binding and launch counter (port of ``repro/kernels/paged_decode/kernel.py``).

The kernel itself is ``csrc/paged_decode.cu``; its header note says what it
replaces, what bounds it and how it is laid out.  ``paged_decode_cuda``
builds the library at first use (:mod:`repro_torch.kernels.build`),
checks its inputs, allocates the output and the split partials, and
launches on PyTorch's current stream.  It takes CUDA tensors only: the
plain version for CPU tensors is ``ref.paged_decode_ref``, chosen by
``ops.paged_decode_attention``.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.autotune import (SMEM_BYTES_PER_BLOCK,
                                          largest_dividing_block,
                                          timing_launches)
from repro_torch.kernels.build import build_library

from .tiling import smem_bytes

__all__ = ["PagedDecodeKernel", "paged_decode_cuda", "SOURCES"]

SOURCES = [Path(__file__).resolve().parent / "csrc" / "paged_decode.cu"]

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128)


class PagedDecodeKernel:
    """Callable wrapper around the CUDA kernel.  ``launches`` counts the
    calls that launched it (one per call, the split combine included);
    launches made while the autotuner times a config count in
    ``tuner_launches`` instead.  ``name`` and ``sources`` pick the library
    (another build of the same C interface, e.g. a variant of the source)."""

    def __init__(self, name: str = "paged_decode", sources: list[Path] = SOURCES):
        self.launches = 0
        self.tuner_launches = 0
        self._lib = None
        self.build_seconds = 0.0
        self.name, self.sources = name, sources

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib, self.build_seconds = build_library(self.name, self.sources)
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.paged_decode_launch.argtypes = (
                [vp] * 9 + [i] * 8 + [ctypes.c_float, i, i, vp])
            lib.paged_decode_launch.restype = i
            lib.paged_decode_smem_bytes.argtypes = [i] * 3
            lib.paged_decode_smem_bytes.restype = ctypes.c_longlong
            self._lib = lib
        return self._lib

    def __call__(self, q, k_pool, v_pool, block_table, cache_len, *,
                 scale: float | None = None, block_kv: int | None = None,
                 n_splits: int = 1) -> torch.Tensor:
        """q: (B, H, Dh); k/v_pool: (P, bs, Hkv, Dh); block_table: (B, NB)
        int32; cache_len: (B,) int32 → (B, H, Dh) in q's dtype, attending
        logical positions ``<= cache_len[b]``.  ``block_kv`` is the kernels'
        token tile, a ceiling: the largest divisor of bs ≤ the request (None:
        128) whose ring fits a block's shared memory in the pools' type.
        ``n_splits`` cuts the KV axis into that many blocks."""
        B, H, Dh = q.shape
        P, bs, Hkv, Dh_k = k_pool.shape
        NB = block_table.shape[1]
        tensors = (q, k_pool, v_pool, block_table, cache_len)
        if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
            raise ValueError("paged_decode_cuda takes CUDA tensors on one device")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("paged_decode_cuda takes contiguous tensors")
        if q.dtype not in _DTYPES or k_pool.dtype not in _DTYPES \
                or v_pool.dtype != k_pool.dtype:
            raise TypeError(f"unsupported dtypes q={q.dtype} "
                            f"k={k_pool.dtype} v={v_pool.dtype}")
        if block_table.dtype != torch.int32 or cache_len.dtype != torch.int32:
            raise TypeError("block_table and cache_len must be int32")
        if (Dh_k != Dh or Dh not in _HEAD_DIMS or H % Hkv
                or v_pool.shape != k_pool.shape
                or tuple(block_table.shape) != (B, NB)
                or tuple(cache_len.shape) != (B,)):
            raise ValueError(
                f"unsupported shapes q={tuple(q.shape)} "
                f"pool={tuple(k_pool.shape)} table={tuple(block_table.shape)} "
                f"cache_len={tuple(cache_len.shape)} (Dh in {_HEAD_DIMS}, "
                f"H divisible by Hkv)")
        if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16 or q.data_ptr() % 4:
            raise ValueError("pools must be 16-byte aligned and q 4-byte aligned")
        rep = H // Hkv
        bkv = largest_dividing_block(bs, block_kv or 128)
        while smem_bytes(Dh, bkv, k_pool.dtype) > SMEM_BYTES_PER_BLOCK:
            bkv = largest_dividing_block(bs, bkv - 1)
        scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
        n_splits = max(1, min(int(n_splits), NB))
        lib = self.load()

        out = torch.empty((B, H, Dh), dtype=q.dtype, device=q.device)
        if n_splits > 1:
            acc = torch.empty((B, Hkv, n_splits, rep, Dh), dtype=torch.float32,
                              device=q.device)
            m = torch.empty((B, Hkv, n_splits, rep), dtype=torch.float32,
                            device=q.device)
            l = torch.empty_like(m)
            parts = (acc.data_ptr(), m.data_ptr(), l.data_ptr())
        else:
            parts = (None, None, None)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = lib.paged_decode_launch(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_table.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
                *parts, B, H, Hkv, Dh, bs, NB, n_splits, bkv, float(scale),
                int(q.dtype == torch.bfloat16),
                int(k_pool.dtype == torch.bfloat16), stream)
        if rc != 0:
            raise RuntimeError(f"paged_decode kernel launch failed "
                               f"(cudaError {rc})")
        if timing_launches():
            self.tuner_launches += 1
        else:
            self.launches += 1
        return out


paged_decode_cuda = PagedDecodeKernel()
