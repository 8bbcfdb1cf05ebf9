"""MM convolution — the Hopper CUDA kernel's build, binding and launch
counter (port of ``repro/kernels/conv_mm/kernel.py``).

The kernels themselves are ``csrc/conv_mm.cu`` (f32: 3xTF32 on ``wgmma``;
bf16: ``wgmma``); its header note says what they replace, what bounds
them and how they are laid out.  ``conv_mm_cuda`` builds
the library at first use (:mod:`repro_torch.kernels.build`), checks its
inputs, picks the tile (``tiling.tile_for``: ``conv_tile`` for f32,
``conv_tile_bf16`` for bf16) and the copy widths
(16-byte copies of x where C is a multiple of 4 f32 or 8 bf16 values, of
w where O is), allocates the output and launches on PyTorch's current
stream.
It takes CUDA tensors only: the plain version for CPU tensors is
``ref.conv_ref``, chosen by ``ops.conv_mm``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library

from .ref import out_hw
from .tiling import tile_for

__all__ = ["ConvMMKernel", "conv_mm_cuda", "SOURCES"]

SOURCES = [Path(__file__).resolve().parent / "csrc" / "conv_mm.cu"]

_DTYPES = (torch.float32, torch.bfloat16)


class ConvMMKernel:
    """Callable wrapper around the CUDA kernel.  ``launches`` counts the
    calls that launched it (one kernel per call)."""

    def __init__(self):
        self.launches = 0
        self._lib = None
        self.build_seconds = 0.0

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib, self.build_seconds = build_library("conv_mm", SOURCES)
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.conv_mm_launch.argtypes = [vp] * 3 + [i] * 16 + [vp]
            lib.conv_mm_launch.restype = i
            lib.conv_mm_smem_bytes.argtypes = [i, i, i]
            lib.conv_mm_smem_bytes.restype = ctypes.c_longlong
            self._lib = lib
        return self._lib

    def __call__(self, x, w, *, stride: int = 1, padding: int = 0,
                 block_o: int | None = None) -> torch.Tensor:
        """x: (N, H, W, C) NHWC; w: (KH, KW, C, O) HWIO, both CUDA, one
        dtype (float32 or bfloat16), contiguous → (N, OH, OW, O) in x's
        dtype.  ``block_o`` is accepted for the reference's signature and
        sets no tile (see the source note)."""
        if x.device.type != "cuda" or w.device != x.device:
            raise ValueError("conv_mm_cuda takes CUDA tensors on one device")
        if x.dtype not in _DTYPES or w.dtype != x.dtype:
            raise TypeError(f"unsupported dtypes x={x.dtype} w={w.dtype} "
                            f"(float32 or bfloat16, one for both)")
        if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
            raise ValueError(f"unsupported shapes x={tuple(x.shape)} "
                             f"w={tuple(w.shape)} (NHWC x, HWIO w, groups 1)")
        if not (x.is_contiguous() and w.is_contiguous()):
            raise ValueError("conv_mm_cuda takes contiguous tensors")
        if x.data_ptr() % x.element_size() or w.data_ptr() % w.element_size():
            raise ValueError("conv_mm_cuda takes element-aligned tensors")
        stride, padding = int(stride), int(padding)
        if stride < 1 or padding < 0:
            raise ValueError(f"stride {stride} must be >= 1 and padding "
                             f"{padding} >= 0")
        N, H, W, C = x.shape
        KH, KW, _, O = w.shape
        OH, OW = out_hw(H, W, KH, KW, stride, padding)
        if min(N, C, O, OH, OW) <= 0:
            raise ValueError(f"empty convolution: x={tuple(x.shape)} "
                             f"w={tuple(w.shape)} stride={stride} "
                             f"padding={padding}")
        if max(x.numel(), w.numel(), N * OH * OW * O) >= 2**31:
            raise ValueError("conv_mm_cuda takes tensors of fewer than 2^31 "
                             "elements")
        bm, bn = tile_for(N * OH * OW, O, x.dtype)
        per16 = 16 // x.element_size()           # values in one 16-byte copy
        vec_a = C % per16 == 0 and x.data_ptr() % 16 == 0
        vec_b = O % per16 == 0 and w.data_ptr() % 16 == 0
        lib = self.load()
        y = torch.empty((N, OH, OW, O), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.conv_mm_launch(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), N, H, W, C, KH, KW,
                O, OH, OW, stride, padding, int(x.dtype == torch.bfloat16),
                bm, bn, int(vec_a), int(vec_b), stream)
        if rc != 0:
            raise RuntimeError(f"conv_mm kernel launch failed (cudaError {rc})")
        self.launches += 1
        return y


conv_mm_cuda = ConvMMKernel()
