#!/usr/bin/env python3
"""Numerics and speed of variants of the bf16 flash attention kernel, on
one card.

    python3 scripts/flash_variants.py [--seeds 3]

Builds variants of ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu`` by editing its text (into ``build/flash_variants/``),
each a library with the kernel's own C interface:

* P in the P·V product as one, two (the kernel as it stands) or three
  bf16 terms, each also with an f32 output in place of the bf16 one, which
  shows the error before the final rounding;
* a ring of three K/V stages in place of two.

At the qwen3-4b prefill shape (B 8, H 32 over 8 KV heads, S 2048, Dh 128,
causal; bf16 inputs drawn on the card from seeds 0, 1, ...) it prints, for
each split and for the f32 kernel of the same library (the inputs
upcast), the largest error of the f32 output against ``attention_ref``
(f32) and the expected count of outputs whose bf16 rounding differs from
the reference's by an ulp of 2^-6 or more: the sum over outputs with
|o| >= 2 of |error| / ulp.  That count is what decides ``chip_smoke.py``'s
bf16 gate (atol 1e-2), since an ulp at |o| >= 2 exceeds it.  Then it times
the bf16 variants in turns (CUDA events, L2 flushed; the order, then the
order reversed) at block_q 1024 and block_k 128, and prints the card line.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "flash_variants"

PV_LO = "Wgmma<DH>::rs(o, p_lo[kk], gmma_desc<SW>(sVs + kk * 16 * SW, BN * SW, 8 * SW));"
ONE_TERM = [(PV_LO, "{}")]
THREE_TERMS = [
    ("uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];",
     "uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4], p_lo2[BN / 16][4];"),
    ("split_bf16(pa0, pa1, p_hi[kk][r], p_lo[kk][r]);",
     "split3(pa0, pa1, p_hi[kk][r], p_lo[kk][r], p_lo2[kk][r]);"),
    ("split_bf16(pb0, pb1, p_hi[kk][r + 1], p_lo[kk][r + 1]);",
     "split3(pb0, pb1, p_hi[kk][r + 1], p_lo[kk][r + 1], p_lo2[kk][r + 1]);"),
    ("template <int N> struct Wgmma;", """
__device__ __forceinline__ void split3(float p0, float p1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  split_bf16(p0 - __low2float(h), p1 - __high2float(h), mid, lo);
}

template <int N> struct Wgmma;"""),
    (PV_LO, "{ " + PV_LO + " " + PV_LO.replace("p_lo[kk]", "p_lo2[kk]") + " }"),
]
F32_OUT = [
    ("*reinterpret_cast<__nv_bfloat162*>(oh + (size_t)(wr0 + lr_a) * DH + col) =",
     "*reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + (size_t)(b * H + h) * Sq * DH"
     " + (size_t)(wr0 + lr_a) * DH + col) ="),
    ("*reinterpret_cast<__nv_bfloat162*>(oh + (size_t)(wr0 + lr_b) * DH + col) =",
     "*reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + (size_t)(b * H + h) * Sq * DH"
     " + (size_t)(wr0 + lr_b) * DH + col) ="),
    ("__floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);",
     "make_float2(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);"),
    ("__floats2bfloat162_rn(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);",
     "make_float2(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);"),
]
THREE_STAGES = [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]
SPLITS = {"one term": ONE_TERM, "two terms": [], "three terms": THREE_TERMS}
TIMED = {"two terms": [], "three terms": THREE_TERMS, "three stages": THREE_STAGES}


def build(name: str, edits) -> ctypes.CDLL:
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path

    from chip_smoke import ptxas_kernels

    text = SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the source no longer has {old!r}")
        text = text.replace(old, new)
    stem = name.replace(" ", "_").replace(",", "")
    cu, so = OUT / f"{stem}.cu", OUT / f"{stem}.so"
    cu.write_text(text)
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    regs = [f"{r} registers, {s} B spilled" for k, r, s in ptxas_kernels(proc.stdout + proc.stderr)
            if k == "flash_attention_bf16_kernel<128, 128>"]
    print(f"build {name}: flash_attention_bf16_kernel<128, 128> {regs[0]}", flush=True)
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [vp] * 4 + [i] * 10 + [ctypes.c_float, i, vp]
    lib.flash_attention_launch.restype = i
    return lib


def launch(lib, q, k, v, out, block_q=1024, block_k=128):
    import torch

    B, H, Sq, Dh = q.shape
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, k.shape[1], Sq,
        k.shape[2], Dh, block_q, block_k, 1, 0, 1 / math.sqrt(Dh),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed (cudaError {rc})")
    return out


def expected_flips(o, ref) -> float:
    """Sum over outputs with |ref| >= 2 of |o - ref| / (bf16 ulp at ref)."""
    import torch

    ulp = torch.where(ref.abs() >= 4, 2.0 ** -5, 2.0 ** -6)
    return float(((o - ref).abs() / ulp)[ref.abs() >= 2].sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()

    import torch

    from chip_smoke import card_line, time_ms
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref

    if not torch.cuda.is_available():
        print("flash_variants: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {**{f"{n}, f32 out": e + F32_OUT for n, e in SPLITS.items()}, **TIMED}
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(lambda kv: build(*kv), jobs.items())))
    f32_lib = flash_attention_cuda.load()

    shapes = ((8, 32, 2048, 128), (8, 8, 2048, 128), (8, 8, 2048, 128))
    for seed in range(args.seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v = (torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
                   for s in shapes)
        ref = attention_ref(q.float(), k.float(), v.float())
        outs = {"f32 kernel": launch(f32_lib, q.float(), k.float(), v.float(),
                                     torch.empty_like(ref), 2048, 256)}
        for name in SPLITS:
            outs[name] = launch(libs[f"{name}, f32 out"], q, k, v, torch.empty_like(ref))
        torch.cuda.synchronize()
        print(f"numerics seed {seed} ({int((ref.abs() >= 2).sum())} outputs with |o| >= 2): "
              + "; ".join(f"{n} max_abs_err {float((o - ref).abs().max()):.3e} expected "
                          f"flips {expected_flips(o, ref):.4f}" for n, o in outs.items()),
              flush=True)
        del ref, outs

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    out = torch.empty_like(q)
    times = {name: [] for name in TIMED}
    for order in (list(TIMED), list(TIMED)[::-1]):
        for name in order:
            times[name].append(time_ms(lambda: launch(libs[name], q, k, v, out), flush, 10, 2))
    print("timing qwen3-4b prefill bf16 causal at block_q 1024, block_k 128: " + "; ".join(
        f"{n} {t[0]:.4f} / {t[1]:.4f} ms" for n, t in times.items()))
    print(f"device {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
