"""Build a kernel's CUDA sources into a shared library and load it with ctypes
(no counterpart in ``repro``: the Pallas kernels needed no build step).

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
compiles the sources into ``build/repro_torch/<name>-<hash>.so`` at the root
of the checkout, keyed by a hash of the sources and the flags, so the first
use after a change rebuilds and later uses load the file.  The sources have
a plain C interface and include no PyTorch header, which keeps a build to
seconds.  The compiler's output (``-Xptxas -v``: registers, shared memory,
spills) is kept beside the library as ``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "build_library", "nvcc_path"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source at "
                       "first use")


def build_library(name: str, sources: list[Path]) -> tuple[ctypes.CDLL, float]:
    """Compile ``sources`` (if the hashed library is missing) and load it.

    Returns the loaded library and the seconds spent compiling (0.0 when
    the library was already built)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
    stem = f"{name}-{digest.hexdigest()[:16]}"
    lib_path = BUILD_DIR / f"{stem}.so"
    seconds = 0.0
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        (BUILD_DIR / f"{stem}.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name} "
                               f"(rc={proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)   # atomic: a concurrent build never sees a torn file
    return ctypes.CDLL(str(lib_path)), seconds
