"""The 3xTF32 paged decode CUDA kernel, run on the CPU in an emulation of
the card: its source (``csrc/paged_decode.cu``) is rewritten into C++ that
g++ compiles against ``tests/_cuda_emu.h`` (one OS thread per CUDA thread;
``ldmatrix`` (also ``.trans``), ``mma.sync`` TF32, ``cp.async``, shuffles
and barriers emulated), built into a shared library with the kernel's own
C interface and launched through it, so the kernel's fragment layouts, its
swizzled ring, its hi/lo row form, its masks, splits and row-group passes
are held against the reference without a card.

Inputs are made from a seed with numpy, rounded once to their type, and go
through the JAX ``paged_decode_ref`` and the Pallas ``paged_decode_kernel``
in interpret mode.  Gates: ``chip_smoke.TOL``, 2e-5 for f32 outputs and
1e-2 for bf16 ones (a bf16 output may round to either neighbour of the same
f32 value).  The type pairs are those the kernel runs: f32 q and pools, f32
q over a bf16 pool (the f32 models' decode), bf16 q over an f32 pool, and
bf16 q and pools at rep 16 (rep <= 8 there runs the bf16 kernel, never
launched here).
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

from repro.kernels.paged_decode import paged_decode_ref as jax_ref
from repro.kernels.paged_decode.kernel import paged_decode_kernel
from repro_torch.kernels.autotune import SMEM_BYTES_PER_BLOCK
from repro_torch.kernels.paged_decode import tiling
from repro_torch.kernels.paged_decode.kernel import SOURCES
from tests._torch_host import port_host_share  # noqa: F401 (autouse)
from tests.test_torch_flash_f32_emulated import _body

HEADER = Path(__file__).resolve().parent / "_cuda_emu.h"
TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def _launches(text: str) -> str:
    """``k<<<grid, threads, smem, stream>>>(`` → ``emu_launch(k, grid,
    threads, smem, `` (commas inside the grid's parentheses kept; the
    stream dropped)."""
    out, pos = [], 0
    for m in re.finditer(r"([\w:<>]+?)<<<", text):
        if m.start() < pos:
            continue
        end = text.index(">>>(", m.end())
        args, depth, cur = [], 0, ""
        for ch in text[m.end():end]:
            depth += {"(": 1, ")": -1}.get(ch, 0)
            if ch == "," and depth == 0:
                args.append(cur.strip())
                cur = ""
            else:
                cur += ch
        args.append(cur.strip())
        assert len(args) == 4, args
        out.append(text[pos:m.start()] + f"emu_launch({m.group(1)}, {', '.join(args[:3])}, ")
        pos = end + 4
    return "".join(out) + text[pos:]


def emulated_source(cuda: str) -> str:
    """The CUDA source rewritten for ``_cuda_emu.h``."""
    text = re.sub(r"#include <(cuda_bf16|cuda_runtime)\.h>\n", "", cuda)
    text = '#include "_cuda_emu.h"\n' + text
    for sig, body in [
            (r"void cp_async16\([^{]*\{", "emu_cp_async16(dst, src, valid ? 16 : 0);"),
            (r"void cp_async_commit\(\)\s*\{", ""),
            (r"void cp_async_wait\(\)\s*\{", ""),
            (r"void ldmatrix_x4\([^{]*\{", "emu_ldsm_x4(addr, r);"),
            (r"void ldmatrix_x4_trans\([^{]*\{", "emu_ldsm_x4_trans(addr, r);"),
            (r"void mma_tf32\([^{]*\{", "emu_mma_tf32(d, a, b0, b1);"),
            (r"float fast_exp2\(float x\)\s*\{", "return exp2f(x);")]:
        text = _body(text, sig, body)
    text = re.sub(r"\basm\s+volatile\s*\(|\basm\s*\(", "EMU_NO_ASM(", text)
    text = re.sub(r"extern __shared__ __align__\(\d+\) ([\w:]+) (\w+)\[\];",
                  r"\1* \2 = reinterpret_cast<\1*>(emu_smem());", text)
    return _launches(text)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel's library, built from the emulated source with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the emulated kernel")
    out = tmp_path_factory.mktemp("paged_decode_emu")
    cpp, lib_path = out / "paged_decode_emu.cpp", out / "paged_decode_emu.so"
    cpp.write_text(emulated_source(SOURCES[0].read_text()))
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-shared", "-fPIC", "-pthread",
                           f"-I{HEADER.parent}", "-o", str(lib_path), str(cpp)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(lib_path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_decode_launch.argtypes = [vp] * 9 + [i] * 8 + [ctypes.c_float, i, i, vp]
    lib.paged_decode_launch.restype = i
    lib.paged_decode_smem_bytes.argtypes = [i] * 3
    lib.paged_decode_smem_bytes.restype = ctypes.c_longlong
    return lib


def _as(a: np.ndarray, dtype: str) -> np.ndarray:
    """``a`` rounded to ``dtype`` (bf16 to nearest even, as JAX does), as
    the f32 values and the buffer the kernel reads."""
    r = np.asarray(jnp.asarray(a, dtype).astype(jnp.float32))
    if dtype == "float32":
        return r, np.ascontiguousarray(r)
    return r, np.ascontiguousarray((r.view(np.uint32) >> 16).astype(np.uint16))


def run_kernel(lib, q, kp, vp, bt, cl, *, q_dtype, kv_dtype, block_kv, n_splits):
    """The emulated kernel on numpy inputs (f32 values of each type) →
    (B, H, Dh) as f32."""
    B, H, Dh = q.shape
    _, bs, Hkv, _ = kp.shape
    NB = bt.shape[1]
    rep = H // Hkv
    qb, kb, vb = _as(q, q_dtype)[1], _as(kp, kv_dtype)[1], _as(vp, kv_dtype)[1]
    out = np.full(qb.shape, 0xFFFF if q_dtype == "bfloat16" else np.nan, qb.dtype)
    parts = [np.zeros((B, Hkv, n_splits, rep, Dh), np.float32),
             np.zeros((B, Hkv, n_splits, rep), np.float32),
             np.zeros((B, Hkv, n_splits, rep), np.float32)]
    bt, cl = np.ascontiguousarray(bt, np.int32), np.ascontiguousarray(cl, np.int32)
    rc = lib.paged_decode_launch(
        qb.ctypes.data, kb.ctypes.data, vb.ctypes.data, bt.ctypes.data, cl.ctypes.data,
        out.ctypes.data, *(p.ctypes.data for p in parts), B, H, Hkv, Dh, bs, NB, n_splits,
        block_kv, 1 / math.sqrt(Dh), int(q_dtype == "bfloat16"),
        int(kv_dtype == "bfloat16"), None)
    assert rc == 0
    if q_dtype == "bfloat16":
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out


def _tiles(Dh, kv_dtype, bs):
    """Every token tile the tuner may return whose ring fits (its
    candidates' tiles), at this head dim and pool type."""
    shape = tiling.shape_key(1, 8, 1, Dh, 4, bs, kv_dtype)
    return sorted({c["block_kv"] for c in tiling.candidates(shape)
                   if tiling.smem_bytes(Dh, c["block_kv"], kv_dtype) <= SMEM_BYTES_PER_BLOCK})


# (q type, pool type, Dh, H, Hkv, bs): rep 1, 4, 5, 8 and 16 over the four
# pairs; each case runs every fitting tile at splits 1, 2 and 4
CASES = [
    ("float32", "float32", 128, 4, 1, 64),         # rep 4, the serving shape's
    ("float32", "float32", 64, 1, 1, 128),         # rep 1, tiles up to 128
    ("float32", "bfloat16", 128, 8, 1, 128),       # rep 8, the f32 models' decode
    ("float32", "bfloat16", 64, 5, 1, 256),        # rep 5, tiles up to 256
    ("bfloat16", "float32", 128, 5, 1, 64),        # rep 5
    ("bfloat16", "float32", 64, 16, 1, 32),        # rep 16 in two row groups
    ("bfloat16", "bfloat16", 64, 16, 1, 64),       # rep 16: the 3xTF32 kernel
    ("bfloat16", "bfloat16", 128, 32, 2, 32),      # rep 16, Dh 128
]


def _inputs(q_dtype, kv_dtype, Dh, H, Hkv, bs, NB, seed):
    """Rows at the cache_len edges: 0, bs - 1, bs and the last position;
    at 2 and 4 splits the first three rows have dead splits."""
    rng = np.random.default_rng(seed)
    B = 4
    P = B * NB + 1
    q = _as(rng.standard_normal((B, H, Dh)), q_dtype)[0]
    kp = _as(rng.standard_normal((P, bs, Hkv, Dh)), kv_dtype)[0]
    vp = _as(3 * rng.standard_normal((P, bs, Hkv, Dh)), kv_dtype)[0]
    bt = (rng.permutation(B * NB).reshape(B, NB) + 1).astype(np.int32)
    cl = np.array([0, bs - 1, bs, NB * bs - 1], np.int32)
    return q, kp, vp, bt, cl


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_kernel_matches_reference(emulated, case):
    q_dtype, kv_dtype, Dh, H, Hkv, bs = case
    NB = 3
    q, kp, vp, bt, cl = _inputs(q_dtype, kv_dtype, Dh, H, Hkv, bs, NB, sum(case[2:]))
    args = [jnp.asarray(q, q_dtype), jnp.asarray(kp, kv_dtype), jnp.asarray(vp, kv_dtype),
            jnp.asarray(bt), jnp.asarray(cl)]
    want = np.asarray(jax_ref(*args).astype(jnp.float32))
    pallas = np.asarray(paged_decode_kernel(*args, n_splits=2, interpret=True)
                        .astype(jnp.float32))
    tol = TOL[q_dtype]
    for bkv in _tiles(Dh, kv_dtype, bs):
        for ns in (1, 2, 4):
            got = run_kernel(emulated, q, kp, vp, bt, cl, q_dtype=q_dtype,
                             kv_dtype=kv_dtype, block_kv=bkv, n_splits=ns)
            assert np.isfinite(got).all(), (bkv, ns)
            np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"{bkv} {ns}")
            np.testing.assert_allclose(got, pallas, rtol=0, atol=tol, err_msg=f"{bkv} {ns}")


def test_emulated_smem_formula_matches_tiling(emulated):
    """The library's ring at each head dim, tile and pool type is the
    tiling model's (as ``chip_smoke.check_smem_formulas`` holds on the
    card)."""
    for Dh in (64, 128):
        for bkv in (1, 8, 16, 17, 32, 64, 100, 128, 256):
            for kv, flag in (("float32", 0), ("bfloat16", 1)):
                assert (emulated.paged_decode_smem_bytes(Dh, bkv, flag)
                        == tiling.smem_bytes(Dh, bkv, kv))
