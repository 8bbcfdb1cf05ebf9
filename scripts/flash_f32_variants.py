#!/usr/bin/env python3
"""Numerics and speed of variants of the f32 (3xTF32) flash attention
kernel, on one card.

    python3 scripts/flash_f32_variants.py [--reps 10]

Builds variants of ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu`` by editing its text (into ``build/flash_f32_variants/``),
each a library with the kernel's own C interface:

* the kernel as it stands (S = Q Kᵀ on ``wgmma``, O += P V on
  ``mma.sync``);
* S on ``mma.sync`` too, each warp loading and splitting K's fragments
  in registers (no lo tile of K in shared memory);
* the register splits (q, P, V) rounded to nearest in both terms
  (``ssd_chunk``'s ``split_tf32``) in place of the truncating one;
* K/V tiles of 32 keys at every block_k;
* a ring of three stages (which leaves room for 32-key tiles only at
  Dh 128);
* 4 warps a block (one warpgroup, 64-row passes) in place of 8, with
  64-key tiles and with 32-key tiles.

It also times a kernel that does nothing but independent
``mma.sync.m16n8k8`` TF32 products on registers, on every SM, which gives
that instruction's ceiling on the card (the data sheet's 495 TFLOP/s TF32
is ``wgmma``'s).

For each it prints ptxas's registers and spills and the SASS HGMMA and
HMMA counts of every f32 instantiation, then holds it against
``attention_ref`` (f32) at ``chip_smoke.py``'s f32 cases (the qwen3-4b
prefill, decode, the 512-query chunk at q_offset 1024, Dh 64
bidirectional at blocks 100 / 150, Dh 32, fully masked rows at Sk 256 and
200), gated at ``FLASH_TOL["float32"]``.  Then it times the variants in
turns (CUDA events, L2 flushed; the order, then the order reversed) at the
prefill shape at block_q 128, 256, 512 and 2048 (block_k 2048), beside
``scaled_dot_product_attention`` in f32, and prints the card line.  Prints
FAILURES [] when every check holds.  Needs a CUDA card and nvcc.
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
OUT = ROOT / "build" / "flash_f32_variants"


def _lines(start: str, end: str) -> str:
    """The source's lines from the one holding ``start`` through the one
    holding ``end``."""
    text = SOURCE.read_text()
    a = text.rindex("\n", 0, text.index(start)) + 1
    return text[a:text.index("\n", text.index(end, a)) + 1]


MMA_SYNC_S = [(_lines("// K's lo part beside its raw tile", "fence_regs(sc);"), """\
      if (t < g_tiles) {
        // S = Q K^T on mma.sync, K's fragments from the raw tile, split in registers
        float sc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 8; kk += 2) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            uint32_t a[4];
            ldsm_x4(smem_addr(Qs + swz(kF32Rows, q_row, 2 * (kk + e) + (li >> 1))), a);
#pragma unroll
            for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[e][i], al[e][i]);
          }
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            uint32_t kb[4], bh[4], bl[4];
            ldsm_x4(smem_addr(Kr + s * BN * DH + swz(BN, 8 * j + lr, 2 * kk + li)), kb);
#pragma unroll
            for (int i = 0; i < 4; ++i) split_tf32(kb[i], bh[i], bl[i]);
            float d[4] = {sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]};
            mma_3xtf32(d, ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
            mma_3xtf32(d, ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
#pragma unroll
            for (int i = 0; i < 4; ++i) sc[4 * j + i] = d[i];
          }
        }
""")]
ROUND_SPLIT = [(
    """  hi = x & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));""",
    """  hi = (x + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;""")]
TILE_32 = [("return block_k > 32 && f32_smem_bytes(Dh, 64) <= (size_t)kMaxSmem ? 64 : 32;",
            "return 32;")]
THREE_STAGES = [("constexpr int kF32Stages = 2;", "constexpr int kF32Stages = 3;")]
FOUR_WARPS = [("constexpr int kF32Warps = 8;", "constexpr int kF32Warps = 4;")]
VARIANTS = {"as it stands": [], "mma.sync S": MMA_SYNC_S, "round split": ROUND_SPLIT,
            "tile 32": TILE_32, "3 stages": THREE_STAGES, "4 warps": FOUR_WARPS,
            "4 warps tile 32": FOUR_WARPS + TILE_32}
MMA_PEAK = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// kChains independent accumulators a warp, each advanced by one m16n8k8
// TF32 product an iteration; operands stay in registers
constexpr int kChains = 12;
__global__ void __launch_bounds__(256) mma_tf32_peak_kernel(float* out, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (seed + threadIdx.x * 7 + i) & 0x3f800000u;
  for (int i = 0; i < 2; ++i) b[i] = (seed + threadIdx.x * 5 + i) & 0x3f800000u;
  float d[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int c = 0; c < kChains; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_tf32_peak(float* out, int blocks, int iters, void* stream) {
  mma_tf32_peak_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, iters, 1u);
  return (int)cudaGetLastError();
}
"""
MMA_PEAK_CHAINS = 12
BLOCK_Q = (128, 256, 512, 2048)


def build(name: str, edits) -> ctypes.CDLL:
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path

    from chip_smoke import ptxas_kernels, sass_mma_count

    text = SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the source no longer has {old!r}")
        text = text.replace(old, new)
    stem = name.replace(" ", "_")
    cu, so = OUT / f"{stem}.cu", OUT / f"{stem}.so"
    cu.write_text(text)
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    sass = sass_mma_count(str(so), by_function=True) or {}
    print(f"build {name}: " + "; ".join(
        f"{k} {r} registers, {s} B spilled, HGMMA {sass.get(k, {}).get('HGMMA', '?')} "
        f"HMMA {sass.get(k, {}).get('HMMA', '?')}"
        for k, r, s in ptxas_kernels(proc.stdout + proc.stderr) if "f32" in k), flush=True)
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [vp] * 4 + [i] * 10 + [ctypes.c_float, i, vp]
    lib.flash_attention_launch.restype = i
    return lib


def mma_peak(time_ms, flush) -> str:
    """TFLOP/s of independent ``mma.sync`` TF32 products on every SM, at 1
    and 2 blocks of 8 warps an SM."""
    import torch

    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path

    cu, so = OUT / "mma_tf32_peak.cu", OUT / "mma_tf32_peak.so"
    cu.write_text(MMA_PEAK)
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"mma peak: nvcc failed\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    lib.mma_tf32_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, rates = 4096, []
    for per_sm in (1, 2):
        blocks = sms * per_sm
        out = torch.empty(blocks * 256, device="cuda")

        def run():
            rc = lib.mma_tf32_peak(out.data_ptr(), blocks, iters,
                                   torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"mma peak launch failed ({rc})")

        ms = time_ms(run, flush, 10, 2)
        flops = blocks * 8 * iters * MMA_PEAK_CHAINS * 2 * 16 * 8 * 8
        rates.append(f"{per_sm} block(s) of 8 warps an SM: {ms:.4f} ms, "
                     f"{flops / ms / 1e9:.1f} TFLOP/s")
    return "; ".join(rates)


def launch(lib, q, k, v, out, *, block_q, block_k, causal=True, q_offset=0):
    import torch

    B, H, Sq, Dh = q.shape
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, k.shape[1], Sq,
        k.shape[2], Dh, block_q, block_k, int(causal), q_offset, 1 / math.sqrt(Dh), 0,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed (cudaError {rc})")
    return out


# (label, B, H, Hkv, Sq, Sk, Dh, causal, q_offset, block_q, block_k)
CASES = [("qwen3-4b prefill", 8, 32, 8, 2048, 2048, 128, True, 0, 256, 2048),
         ("decode", 8, 32, 8, 1, 2048, 128, True, 2047, 1, 2048),
         ("512-query chunk", 8, 32, 8, 512, 2048, 128, True, 1024, 512, 512),
         ("bidirectional Dh=64", 2, 16, 4, 200, 300, 64, False, 0, 100, 150),
         ("Dh=32", 2, 8, 2, 256, 256, 32, True, 0, 128, 64),
         ("rows 0-3 fully masked", 1, 32, 8, 64, 256, 128, True, -4, 64, 64),
         ("rows 0-3 fully masked", 1, 32, 8, 64, 200, 128, True, -4, 64, 64)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    from chip_smoke import FLASH_TOL, card_line, time_ms
    from repro_torch.kernels.flash_attention.ref import attention_ref

    if not torch.cuda.is_available():
        print("flash_f32_variants: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device {card_line()}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))

    failures = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, B, H, Hkv, Sq, Sk, Dh, causal, off, bq, bk in CASES:
        q = torch.randn(B, H, Sq, Dh, generator=gen, device="cuda")
        k = torch.randn(B, Hkv, Sk, Dh, generator=gen, device="cuda")
        v = torch.randn(B, Hkv, Sk, Dh, generator=gen, device="cuda")
        want = attention_ref(q, k, v, causal=causal, q_offset=off)
        errs = {}
        for name, lib in libs.items():
            got = launch(lib, q, k, v, torch.empty_like(q), block_q=bq, block_k=bk,
                         causal=causal, q_offset=off)
            torch.cuda.synchronize()
            err = float((got - want).abs().max()) if torch.isfinite(got).all() else math.inf
            errs[name] = err
            if not err <= FLASH_TOL["float32"]:
                failures.append((name, label, err))
        print(f"check {label} B={B} H={H} Hkv={Hkv} Sq={Sq} Sk={Sk} Dh={Dh} causal={causal} "
              f"q_offset={off} block_q={bq} block_k={bk}: " + "; ".join(
                  f"{n} {e:.3e}" for n, e in errs.items()), flush=True)
        del q, k, v, want

    B, H, Hkv, S, Dh = 8, 32, 8, 2048, 128
    q = torch.randn(B, H, S, Dh, generator=gen, device="cuda")
    k = torch.randn(B, Hkv, S, Dh, generator=gen, device="cuda")
    v = torch.randn(B, Hkv, S, Dh, generator=gen, device="cuda")
    kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    out = torch.empty_like(q)
    flops = 4 * B * H * S * S * Dh * 0.5
    sdpa = [time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True),
                    flush, args.reps, 2)]
    times = {(n, bq): [] for n in VARIANTS for bq in BLOCK_Q}
    for order in (list(VARIANTS), list(VARIANTS)[::-1]):
        for name in order:
            for bq in BLOCK_Q:
                times[name, bq].append(time_ms(
                    lambda: launch(libs[name], q, k, v, out, block_q=bq, block_k=2048),
                    flush, args.reps, 2))
    sdpa.append(time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True),
                        flush, args.reps, 2))
    print(f"timing mma.sync m16n8k8 TF32 peak ({MMA_PEAK_CHAINS} independent products a "
          f"warp, operands in registers): {mma_peak(time_ms, flush)}", flush=True)
    bound_tc = 3 * flops / 495e12 * 1e3
    print(f"timing qwen3-4b prefill B={B} H={H} Hkv={Hkv} S={S} Dh={Dh} f32 causal, "
          f"scaled_dot_product_attention f32 {sdpa[0]:.4f} / {sdpa[1]:.4f} ms; 3xTF32 bound "
          f"{bound_tc:.4f} ms, CUDA-core bound {flops / 67e12 * 1e3:.4f} ms", flush=True)
    for name in VARIANTS:
        print(f"timing {name}: " + "; ".join(
            f"block_q {bq} {times[name, bq][0]:.4f} / {times[name, bq][1]:.4f} ms "
            f"({flops / min(times[name, bq]) / 1e9:.1f} TFLOP/s, "
            f"{bound_tc / min(times[name, bq]):.1%} of the 3xTF32 bound)"
            for bq in BLOCK_Q), flush=True)
    print(f"FAILURES {failures}")
    print(f"device {card_line()}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
