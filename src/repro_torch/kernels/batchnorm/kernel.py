"""BatchNorm with batch statistics and its activation — the Hopper CUDA
kernels' build, binding and launch counter.

The kernels are ``csrc/batchnorm.cu``; its header note says what they
compute, what bounds them and how they are laid out.  ``batchnorm_cuda``
builds the library at first use (:mod:`repro_torch.kernels.build`),
checks its inputs, picks the load width (16-byte loads where C is a
multiple of 4 and the full-size tensors are 16-byte aligned), allocates
the outputs and the scratch of per-chunk partials, launches on PyTorch's
current stream and counts the launches of each direction.  It takes CUDA f32 tensors only: the plain
version for CPU and meta tensors is ``ref.batchnorm_act_ref``, chosen by
``ops.batchnorm_act``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library

from .ref import ACTS

__all__ = ["BatchNormKernel", "batchnorm_cuda", "SOURCES"]

SOURCES = [Path(__file__).resolve().parent / "csrc" / "batchnorm.cu"]


class BatchNormKernel:
    """Wrapper around the CUDA kernels.  ``forward_launches`` and
    ``backward_launches`` count the calls of each direction whose launch
    succeeded (three kernels a call); set them to 0 to count a window."""

    def __init__(self):
        self.forward_launches = 0
        self.backward_launches = 0
        self.build_seconds = 0.0
        self._lib = None
        self._chunks: dict[tuple, int] = {}

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib, self.build_seconds = build_library("batchnorm", SOURCES)
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.batchnorm_chunks.argtypes = [i] * 5
            lib.batchnorm_chunks.restype = i
            lib.batchnorm_forward.argtypes = [vp] * 7 + [i] * 5 + [vp]
            lib.batchnorm_forward.restype = i
            lib.batchnorm_backward.argtypes = [vp] * 10 + [i] * 5 + [vp]
            lib.batchnorm_backward.restype = i
            self._lib = lib
        return self._lib

    def _scratch(self, M: int, C: int, act: int, vec: bool, backward: bool, device):
        """(chunks, scratch of 2 · chunks · C floats) for one call."""
        key = (M, C, act, vec, backward)
        if key not in self._chunks:
            self._chunks[key] = self.load().batchnorm_chunks(M, C, act, int(vec), int(backward))
        chunks = self._chunks[key]
        if chunks <= 0:
            raise RuntimeError(f"batchnorm: no launch geometry for M={M} C={C}")
        return chunks, torch.empty((2, chunks, C), dtype=torch.float32, device=device)

    @staticmethod
    def _check(big: dict, small: dict, act: str) -> tuple[int, int]:
        """(M, C) of the (…, C) tensors in ``big`` with the (C,) tensors in
        ``small``; raises on anything the kernels do not take."""
        if act not in ACTS:
            raise ValueError(f"unknown activation {act!r} (one of {ACTS})")
        first = next(iter(big.values()))
        for name, t in {**big, **small}.items():
            if t.device.type != "cuda" or t.device != first.device:
                raise ValueError(f"batchnorm_cuda takes CUDA tensors on one device "
                                 f"({name} is on {t.device})")
            if t.dtype != torch.float32:
                raise TypeError(f"batchnorm_cuda takes float32 tensors ({name} is {t.dtype})")
            if not t.is_contiguous():
                raise ValueError(f"batchnorm_cuda takes contiguous tensors ({name} is not)")
        if first.dim() != 4:
            raise ValueError(f"batchnorm_cuda takes (N, H, W, C) tensors, not "
                             f"{tuple(first.shape)}")
        C = first.shape[-1]
        M = first.numel() // C if C else 0
        if M <= 0 or C <= 0:
            raise ValueError(f"empty BatchNorm input {tuple(first.shape)}")
        if first.numel() >= 2**31:
            raise ValueError("batchnorm_cuda takes tensors of fewer than 2^31 elements")
        for name, t in big.items():
            if t.shape != first.shape:
                raise ValueError(f"{name} {tuple(t.shape)} is not {tuple(first.shape)}")
        for name, t in small.items():
            if t.shape != (C,):
                raise ValueError(f"{name} {tuple(t.shape)} is not ({C},)")
        return M, C

    @staticmethod
    def _vec(C: int, *tensors) -> bool:
        return C % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)

    def forward(self, y, scale, shift, act: str):
        """y: (N, H, W, C); scale, shift: (C,), all CUDA f32 and contiguous →
        (z, mean, rstd): z = act(((y − mean)·rstd)·scale + shift) like y,
        the batch mean and rsqrt(biased var + 1e-5) of each channel."""
        M, C = self._check({"y": y}, {"scale": scale, "shift": shift}, act)
        z = torch.empty_like(y)
        mean = torch.empty(C, dtype=torch.float32, device=y.device)
        rstd = torch.empty(C, dtype=torch.float32, device=y.device)
        vec = self._vec(C, y, z)
        code = ACTS.index(act)
        chunks, scratch = self._scratch(M, C, code, vec, False, y.device)
        with torch.cuda.device(y.device):
            stream = torch.cuda.current_stream(y.device).cuda_stream
            rc = self.load().batchnorm_forward(
                y.data_ptr(), scale.data_ptr(), shift.data_ptr(), z.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), scratch.data_ptr(), M, C, chunks,
                code, int(vec), stream)
        if rc != 0:
            raise RuntimeError(f"batchnorm forward launch failed (cudaError {rc})")
        self.forward_launches += 1
        return z, mean, rstd

    def backward(self, dz, y, scale, shift, mean, rstd, act: str):
        """The gradients (dy, dscale, dshift) of ``forward``'s z at dz, from
        its input y, scale, shift and its mean and rstd (all CUDA f32,
        contiguous)."""
        M, C = self._check({"dz": dz, "y": y}, {"scale": scale, "shift": shift,
                                                 "mean": mean, "rstd": rstd}, act)
        dy = torch.empty_like(y)
        dscale = torch.empty(C, dtype=torch.float32, device=y.device)
        dshift = torch.empty(C, dtype=torch.float32, device=y.device)
        vec = self._vec(C, dz, y, dy)
        code = ACTS.index(act)
        chunks, scratch = self._scratch(M, C, code, vec, True, y.device)
        with torch.cuda.device(y.device):
            stream = torch.cuda.current_stream(y.device).cuda_stream
            rc = self.load().batchnorm_backward(
                dz.data_ptr(), y.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(), dscale.data_ptr(),
                dshift.data_ptr(), scratch.data_ptr(), M, C, chunks, code, int(vec), stream)
        if rc != 0:
            raise RuntimeError(f"batchnorm backward launch failed (cudaError {rc})")
        self.backward_launches += 1
        return dy, dscale, dshift


batchnorm_cuda = BatchNormKernel()
