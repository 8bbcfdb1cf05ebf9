"""The f32 flash attention CUDA kernel, run on the CPU in an emulation of
the card: its source (``csrc/flash_attention.cu``) is rewritten into C++
that g++ compiles against ``tests/_cuda_emu.h`` (one OS thread per CUDA
thread; ``ldmatrix``, ``mma.sync`` and ``wgmma`` TF32, ``cp.async``,
shuffles and barriers emulated), built into a shared library with the
kernel's own C interface and launched through it, so the kernel's fragment
layouts, its swizzled tiles and descriptors, its 3xTF32 split, its ring,
its masks and its causal skips are held against the reference without a
card.  Inputs are made from a seed with numpy and go through the JAX
``attention_ref`` (f32) and the port's plain version; the gate is
``chip_smoke.FLASH_TOL["float32"]`` = 1e-4.  The emulated products sum in
another order than the card's, and both stay near 1e-6.
"""

import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.autotune import largest_dividing_block
from repro_torch.kernels.flash_attention import attention_ref, tiling
from repro_torch.kernels.flash_attention.kernel import SOURCES
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

HEADER = Path(__file__).resolve().parent / "_cuda_emu.h"
TOL = 1e-4


def _body(text: str, signature: str, body: str) -> str:
    """``text`` with the body of the function whose signature matches the
    regex ``signature`` (up to its opening brace) replaced by ``body``."""
    m = re.search(signature, text)
    assert m, signature
    depth, start = 0, m.end() - 1
    for end in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[end], 0)
        if depth == 0:
            break
    return text[:start] + "{ " + body + " }" + text[end + 1:]


def emulated_source(cuda: str) -> str:
    """The CUDA source rewritten for ``_cuda_emu.h``."""
    text = re.sub(r"#include <(cuda|cuda_bf16|cuda_runtime)\.h>\n", "", cuda)
    text = '#include "_cuda_emu.h"\n' + text
    for sig, body in [(r"void cp_async16\([^{]*\{", "emu_cp_async16(dst, src, src_bytes);"),
                      (r"void cp_async_commit\(\)\s*\{", ""),
                      (r"void cp_async_wait\(\)\s*\{", ""),
                      (r"void ldsm_x4\([^{]*\{", "emu_ldsm_x4(addr, r);"),
                      (r"void mma_tf32\([^{]*\{", "emu_mma_tf32(d, a, b0, b1);"),
                      (r"float ex2\(float x\)\s*\{", "return exp2f(x);")]:
        text = _body(text, sig, body)
    for n in (32, 64):
        at = text.index(f"template <> struct WgmmaTf32<{n}>")
        text = text[:at] + _body(text[at:], r"void rs\([^{]*\{",
                                 f"emu_wgmma_tf32_rs<{n}>(d, a, db);")
    text = re.sub(r"\basm\s+volatile\s*\(|\basm\s*\(", "EMU_NO_ASM(", text)
    text = re.sub(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                  r"float* \1 = reinterpret_cast<float*>(emu_smem());", text)
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
    out = tmp_path_factory.mktemp("flash_f32_emu")
    cpp, lib_path = out / "flash_attention_emu.cpp", out / "flash_attention_emu.so"
    cpp.write_text(emulated_source(SOURCES[0].read_text()))
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-shared", "-fPIC", "-pthread",
                           f"-I{HEADER.parent}", "-o", str(lib_path), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(lib_path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [vp] * 4 + [i] * 10 + [ctypes.c_float, i, vp]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_smem_bytes.argtypes = [i, i, i]
    lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


# (B, H, Hkv, Sq, Sk, Dh, causal, block_q, block_k, q_offset)
CASES = [
    (1, 2, 1, 40, 72, 32, True, 40, 72, 0),         # one pass, ragged 64-key tile
    (1, 2, 2, 130, 130, 32, True, 130, 64, 0),      # two passes
    (1, 4, 2, 200, 300, 64, False, 100, 150, 0),    # bidirectional, GQA
    (1, 2, 2, 64, 200, 128, True, 64, 64, -4),      # rows 0-3 fully masked, ragged Sk
    (2, 4, 1, 1, 300, 128, True, 512, 512, 299),    # decode, MQA
    (1, 2, 1, 64, 256, 64, True, 64, 64, 1024),     # a chunk far past the keys
    (1, 2, 2, 64, 100, 32, True, 64, 32, -70),      # 32-key tiles, rows 0-69 masked
    (1, 2, 1, 150, 96, 32, True, 50, 16, 20),       # three q-blocks, 32-key tiles
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulated_f32_kernel_matches_reference(emulated, case):
    B, H, Hkv, Sq, Sk, Dh, causal, bq, bk, off = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, Sq, Dh), (B, Hkv, Sk, Dh), (B, Hkv, Sk, Dh)))
    out = np.full_like(q, np.nan)
    rc = emulated.flash_attention_launch(
        q.ctypes.data, k.ctypes.data, v.ctypes.data, out.ctypes.data, B, H, Hkv, Sq, Sk, Dh,
        largest_dividing_block(Sq, bq), largest_dividing_block(Sk, bk), int(causal), off,
        1 / math.sqrt(Dh), 0, None)
    assert rc == 0
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                              q_offset=off))
    plain = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                          q_offset=off).numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(out, plain, rtol=0, atol=TOL)


def test_emulated_smem_formula_matches_tiling(emulated):
    """The library's f32 shared memory at each head dim and block_k is
    the tiling model's (as ``chip_smoke.check_smem_formulas`` holds on the
    card)."""
    for Dh in (32, 64, 128):
        for bk in (1, 16, 32, 33, 64, 100, 512, 2048):
            assert (emulated.flash_attention_smem_bytes(Dh, bk, 0)
                    == tiling.smem_bytes(Dh, bk, "float32"))
