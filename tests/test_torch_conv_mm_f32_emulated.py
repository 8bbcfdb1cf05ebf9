"""The f32 convolution CUDA kernel (``conv_mm_tf32_wgmma_kernel``, 3xTF32 on
``wgmma``), run on the CPU in an emulation of the card: its source
(``csrc/conv_mm.cu``) is rewritten into C++ that g++ compiles against
``tests/_cuda_emu.h`` (one OS thread per CUDA thread; ``ldmatrix``,
``wgmma`` TF32, 16- and 4-byte ``cp.async`` with zero fill and barriers
emulated), built into a shared library with the kernel's own C interface
and launched through it at a forced tile (64 x 64 or 128 x 128, the
only ones it takes), so the kernel's im2col gather
(16-byte copies of 4 channels, or 4-byte copies walking the taps), its
swizzled tiles and descriptors, its K-major rewrite of the weights into
hi and lo tiles, its 3xTF32 split, its ring, its per-chunk sums and its
masked epilogue are held against the reference without a card.  Inputs
are made from a seed with numpy (outputs of unit variance) and go
through the JAX ``conv_ref`` and the port's plain version; the gate is
``chip_smoke.CONV_TOL["float32"]`` = (1e-4, 1e-4).  The emulated products
sum in another order than the card's, and both stay near 1e-6.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_mm.ref import conv_ref as jax_conv
from repro_torch.kernels.conv_mm import conv_ref, tiling
from repro_torch.kernels.conv_mm.kernel import SOURCES
from repro_torch.kernels.conv_mm.ref import out_hw
from tests._torch_host import port_host_share  # noqa: F401 (autouse)
from tests.test_torch_flash_f32_emulated import _body

HEADER = Path(__file__).resolve().parent / "_cuda_emu.h"
RTOL = ATOL = 1e-4
TILES = [(64, 64), (128, 128)]            # the f32 kernel's tiles
MIXED = [(64, 128), (128, 64)]            # bf16 only


def emulated_source(cuda: str) -> str:
    """The CUDA source rewritten for ``_cuda_emu.h``."""
    text = re.sub(r"#include <(cuda_bf16|cuda_runtime)\.h>\n", "", cuda)
    text = '#include "_cuda_emu.h"\n' + text
    for sig, body in [(r"void cp_async16\([^{]*\{", "emu_cp_async16(dst, src, ok ? 16 : 0);"),
                      (r"void cp_async4\([^{]*\{", "emu_cp_async4(dst, src, ok ? 4 : 0);"),
                      (r"void cp_async_commit\(\)\s*\{", ""),
                      (r"void cp_async_wait\(\)\s*\{", ""),
                      (r"void ldsm_x4\([^{]*\{", "emu_ldsm_x4(addr, r);")]:
        text = _body(text, sig, body)
    for n in (64, 128):
        at = text.index(f"template <> struct WgmmaTf32<{n}>")
        text = text[:at] + _body(text[at:], r"void rs\([^{]*\{",
                                 f"emu_wgmma_tf32_rs<{n}>(d, a, db, scale_d);")
    text = re.sub(r"\basm\s+volatile\s*\(|\basm\s*\(", "EMU_NO_ASM(", text)
    text = re.sub(r"extern __shared__ uint8_t (\w+)\[\];",
                  r"uint8_t* \1 = reinterpret_cast<uint8_t*>(emu_smem());", text)
    return re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*([^>]+)>>>\(",
                  r"emu_launch(\1, \2, \3, \4, ", text)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel's library, built from the emulated source with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the emulated kernel")
    out = tmp_path_factory.mktemp("conv_mm_f32_emu")
    cpp, lib_path = out / "conv_mm_emu.cpp", out / "conv_mm_emu.so"
    cpp.write_text(emulated_source(SOURCES[0].read_text()))
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-shared", "-fPIC", "-pthread",
                           f"-I{HEADER.parent}", "-o", str(lib_path), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(lib_path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_mm_launch.argtypes = [vp] * 3 + [i] * 16 + [vp]
    lib.conv_mm_launch.restype = i
    lib.conv_mm_smem_bytes.argtypes = [i, i, i]
    lib.conv_mm_smem_bytes.restype = ctypes.c_longlong
    return lib


# (N, H, W, C, K, O, stride, padding, tile)
CASES = [
    (1, 6, 5, 3, 3, 8, 1, 1, (64, 64)),        # the stem's C 3: 4-byte gather, K 27
    (1, 5, 5, 2, 3, 8, 1, 1, (64, 64)),        # C 2: a step of 4 depths crosses taps
    (1, 6, 6, 13, 3, 24, 1, 1, (128, 128)),    # C 13: 4-byte gather over 4 chunks
    (2, 5, 5, 20, 3, 16, 1, 1, (64, 64)),      # K 180: a ragged last chunk
    (1, 6, 6, 8, 3, 13, 1, 1, (64, 64)),       # O 13: 4-byte w copies, element stores
    (1, 7, 5, 12, 3, 70, 1, 1, (64, 64)),      # O 70: a ragged second channel tile
    (1, 9, 9, 8, 3, 16, 2, 1, (64, 64)),       # stride 2, padding 1
    (2, 4, 4, 16, 1, 32, 1, 0, (64, 64)),      # 1 x 1
    (1, 9, 9, 8, 5, 8, 2, 2, (64, 64)),        # 5 x 5, stride 2
    # every tile: 162 pixels, K 144 (5 chunks: the ring wraps), O 136 (a
    # ragged channel tile with 16-byte copies)
    *((2, 9, 9, 16, 3, 136, 1, 1, t) for t in TILES),
]


def _inputs(case):
    N, H, W, C, K, O, *_ = case
    rng = np.random.default_rng(sum(case[:6]))
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((K, K, C, O)) / np.sqrt(K * K * C)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulated_f32_kernel_matches_reference(emulated, case):
    N, H, W, C, K, O, s, p, (bm, bn) = case
    x, w = _inputs(case)
    OH, OW = out_hw(H, W, K, K, s, p)
    y = np.full((N, OH, OW, O), np.nan, np.float32)
    vec_a = int(C % 4 == 0 and x.ctypes.data % 16 == 0)
    vec_b = int(O % 4 == 0 and w.ctypes.data % 16 == 0)
    rc = emulated.conv_mm_launch(x.ctypes.data, w.ctypes.data, y.ctypes.data, N, H, W, C, K,
                                 K, O, OH, OW, s, p, 0, bm, bn, vec_a, vec_b, None)
    assert rc == 0
    want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w), stride=s, padding=p))
    plain = conv_ref(torch.from_numpy(x), torch.from_numpy(w), stride=s, padding=p).numpy()
    np.testing.assert_allclose(y, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y, plain, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tile", MIXED, ids=str)
def test_emulated_f32_kernel_refuses_a_mixed_tile(emulated, tile):
    """f32 launches at 64 x 64 and 128 x 128 alone: a mixed tile, which
    the f32 rule never gives, returns cudaErrorInvalidValue (1) and writes
    nothing."""
    case = (2, 9, 9, 16, 3, 136, 1, 1)
    N, H, W, C, K, O, s, p = case
    x, w = _inputs(case)
    y = np.full((N, H, W, O), np.nan, np.float32)
    rc = emulated.conv_mm_launch(x.ctypes.data, w.ctypes.data, y.ctypes.data, N, H, W, C, K,
                                 K, O, H, W, s, p, 0, *tile, 1, 1, None)
    assert rc == 1
    assert np.isnan(y).all()


def test_emulated_smem_formula_matches_tiling(emulated):
    """The library's shared memory at every tile is the tiling model's, for
    both kernels (as ``chip_smoke.check_smem_formulas`` holds on the
    card)."""
    for bm, bn in TILES + MIXED:
        for dtype, flag in (("float32", 0), ("bfloat16", 1)):
            assert emulated.conv_mm_smem_bytes(bm, bn, flag) == tiling.smem_bytes(bm, bn, dtype)
