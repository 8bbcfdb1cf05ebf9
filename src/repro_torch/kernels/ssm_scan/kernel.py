"""SSD intra-chunk pass — the Hopper CUDA kernel's build, binding and
launch counter (port of ``repro/kernels/ssm_scan/kernel.py``).

The kernel itself is ``csrc/ssd_chunk.cu``; its header note says what it
replaces, what bounds it and how it is laid out.  ``ssd_chunk_cuda``
builds the library at first use (:mod:`repro_torch.kernels.build`), checks
its inputs, allocates the four outputs and launches on PyTorch's current
stream.  It takes CUDA tensors only: the plain version for CPU tensors is
``ref.ssd_chunk_ref``, chosen by ``ops.ssd``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.autotune import SMEM_BYTES_PER_BLOCK, timing_launches
from repro_torch.kernels.build import build_library

from .tiling import smem_bytes

__all__ = ["SsdChunkKernel", "ssd_chunk_cuda", "SOURCES"]

SOURCES = [Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"]

_DTYPES = (torch.float32, torch.bfloat16)


class SsdChunkKernel:
    """Callable wrapper around the CUDA kernel.  ``launches`` counts the
    calls that launched it, one kernel per call; launches made while the
    autotuner times a config count in ``tuner_launches`` instead.
    ``name`` and ``sources`` pick the library (another build of the same C
    interface, e.g. a variant of the source)."""

    def __init__(self, name: str = "ssd_chunk", sources: list[Path] = SOURCES):
        self.launches = 0
        self.tuner_launches = 0
        self._lib = None
        self.build_seconds = 0.0
        self.name, self.sources = name, sources

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib, self.build_seconds = build_library(self.name, self.sources)
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.ssd_chunk_launch.argtypes = [vp] * 8 + [i] * 7 + [vp]
            lib.ssd_chunk_launch.restype = i
            lib.ssd_chunk_smem_bytes.argtypes = [i, i, i]
            lib.ssd_chunk_smem_bytes.restype = ctypes.c_longlong
            self._lib = lib
        return self._lib

    def __call__(self, xh, a, Bm, Cm, *, chunk: int):
        """xh: (B, S, H, P); a: (B, S, H) (taken as f32); Bm, Cm: (B, S, N),
        CUDA, xh/Bm/Cm one dtype (float32 or bfloat16); ``chunk`` divides
        S.  Returns (y_diag, states, chunk_decay, cum) as
        ``ref.ssd_chunk_ref``."""
        tensors = (xh, a, Bm, Cm)
        if xh.device.type != "cuda" or any(t.device != xh.device for t in tensors):
            raise ValueError("ssd_chunk_cuda takes CUDA tensors on one device")
        if xh.dtype not in _DTYPES or Bm.dtype != xh.dtype or Cm.dtype != xh.dtype:
            raise TypeError(f"unsupported dtypes xh={xh.dtype} B={Bm.dtype} "
                            f"C={Cm.dtype} (float32 or bfloat16, one for all)")
        if xh.dim() != 4:
            raise ValueError(f"unsupported shape xh={tuple(xh.shape)}")
        B, S, H, P = xh.shape
        N = Bm.shape[-1]
        chunk = int(chunk)
        if (tuple(a.shape) != (B, S, H) or tuple(Bm.shape) != (B, S, N)
                or Cm.shape != Bm.shape or chunk < 1 or S % chunk):
            raise ValueError(f"unsupported shapes xh={tuple(xh.shape)} "
                             f"a={tuple(a.shape)} B={tuple(Bm.shape)} "
                             f"C={tuple(Cm.shape)} chunk={chunk} (chunk "
                             f"must divide S)")
        if smem_bytes(chunk, N, P) > SMEM_BYTES_PER_BLOCK:
            raise ValueError(
                f"chunk={chunk} at N={N}, P={P} needs {smem_bytes(chunk, N, P)} "
                f"bytes of shared memory per block (> {SMEM_BYTES_PER_BLOCK})")
        xh, Bm, Cm = xh.contiguous(), Bm.contiguous(), Cm.contiguous()
        a = a.float().contiguous()
        nc = S // chunk
        lib = self.load()
        y = torch.empty_like(xh)
        f32 = dict(dtype=torch.float32, device=xh.device)
        states = torch.empty((B, nc, H, N, P), **f32)
        decay = torch.empty((B, nc, H), **f32)
        cum = torch.empty((B, nc, H, chunk), **f32)
        with torch.cuda.device(xh.device):
            stream = torch.cuda.current_stream(xh.device).cuda_stream
            rc = lib.ssd_chunk_launch(
                xh.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                y.data_ptr(), states.data_ptr(), decay.data_ptr(),
                cum.data_ptr(), B, S, H, P, N, chunk,
                int(xh.dtype == torch.bfloat16), stream)
        if rc != 0:
            raise RuntimeError(f"ssd_chunk kernel launch failed (cudaError {rc})")
        if timing_launches():
            self.tuner_launches += 1
        else:
            self.launches += 1
        return y, states, decay, cum


ssd_chunk_cuda = SsdChunkKernel()
