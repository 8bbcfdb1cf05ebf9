"""Flash attention — the Hopper CUDA kernel's build, binding and launch
counter (port of ``repro/kernels/flash_attention/kernel.py``).

The kernel itself is ``csrc/flash_attention.cu``; its header note says what
it replaces, what bounds it and how it is laid out.  ``flash_attention_cuda``
builds the library at first use (:mod:`repro_torch.kernels.build`), snaps
the blocks as the reference does (``largest_dividing_block``: Sq = 384 with
block_q 512 runs one 384-row block), checks its inputs, allocates the
output and launches on PyTorch's current stream.  The dtype picks the
kernel in the one library, both on the tensor cores: bf16 on ``wgmma``,
f32 as three TF32 products per f32 product (3xTF32: S on ``wgmma``, P·V
on ``mma.sync``), which keeps f32 accuracy.  It takes CUDA tensors only:
the plain version for CPU tensors is ``ref.attention_ref``, chosen by
``ops.flash_attention``.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.autotune import (
    SMEM_BYTES_PER_BLOCK,
    largest_dividing_block,
    timing_launches,
)
from repro_torch.kernels.build import build_library

from .tiling import smem_bytes

__all__ = ["FlashAttentionKernel", "flash_attention_cuda", "SOURCES"]

SOURCES = [Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"]

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64, 128)


class FlashAttentionKernel:
    """Callable wrapper around the CUDA kernel.  ``launches`` counts the
    calls that launched it, one kernel per call; launches made while the
    autotuner times a config count in ``tuner_launches`` instead."""

    def __init__(self):
        self.launches = 0
        self.tuner_launches = 0
        self._lib = None
        self.build_seconds = 0.0

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib, self.build_seconds = build_library("flash_attention", SOURCES)
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.flash_attention_launch.argtypes = (
                [vp] * 4 + [i] * 10 + [ctypes.c_float, i, vp])
            lib.flash_attention_launch.restype = i
            lib.flash_attention_smem_bytes.argtypes = [i, i, i]
            lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
            self._lib = lib
        return self._lib

    def __call__(self, q, k, v, *, causal: bool = True,
                 scale: float | None = None, block_q: int = 512,
                 block_k: int = 512, q_offset: int = 0) -> torch.Tensor:
        """q: (B, H, Sq, Dh); k, v: (B, Hkv, Sk, Dh), CUDA, contiguous, one
        dtype (float32 or bfloat16) → (B, H, Sq, Dh) in q's dtype.
        ``q_offset`` is the position of q[0] relative to k[0]."""
        if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
            raise ValueError("flash_attention_cuda takes CUDA tensors on one device")
        if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"unsupported dtypes q={q.dtype} k={k.dtype} "
                            f"v={v.dtype} (float32 or bfloat16, one for all)")
        if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
            raise ValueError(f"unsupported shapes q={tuple(q.shape)} "
                             f"k={tuple(k.shape)} v={tuple(v.shape)}")
        B, H, Sq, Dh = q.shape
        _, Hkv, Sk, Dh_k = k.shape
        if (k.shape[0] != B or Dh_k != Dh or Dh not in _HEAD_DIMS or Hkv < 1
                or H % Hkv or min(Sq, Sk) < 1):
            raise ValueError(f"unsupported shapes q={tuple(q.shape)} "
                             f"k={tuple(k.shape)} (Dh in {_HEAD_DIMS}, H "
                             f"divisible by Hkv)")
        if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
            raise ValueError("flash_attention_cuda takes contiguous tensors")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention_cuda takes 16-byte aligned "
                             "tensors (TMA for bf16, cp.async for f32)")
        block_q = largest_dividing_block(Sq, block_q)
        block_k = largest_dividing_block(Sk, block_k)
        smem = smem_bytes(Dh, block_k, q.dtype)
        if smem > SMEM_BYTES_PER_BLOCK:
            raise ValueError(
                f"block_k={block_k} at Dh={Dh} needs {smem} bytes of shared "
                f"memory per block (> {SMEM_BYTES_PER_BLOCK})")
        scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
        lib = self.load()
        out = torch.empty_like(q)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, Hkv, Sq, Sk, Dh, block_q, block_k, int(bool(causal)),
                int(q_offset), float(scale), int(q.dtype == torch.bfloat16),
                stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention kernel launch failed "
                               f"(cudaError {rc})")
        if timing_launches():
            self.tuner_launches += 1
        else:
            self.launches += 1
        return out


flash_attention_cuda = FlashAttentionKernel()
