#!/usr/bin/env python3
"""Speed of variants of the bf16 ``conv_mm`` kernel (the ``wgmma`` implicit
GEMM), on one card.

    python3 scripts/conv_mm_variants.py

Builds variants of ``src/repro_torch/kernels/conv_mm/csrc/conv_mm.cu`` by
editing its text (into ``build/conv_mm_variants/``), each a library with
the kernel's own C interface:

* the kernel as it stands (a ring of 4 stages, chunk k + 2 loading while
  chunk k multiplies, the output tile staged in shared memory and stored
  in 16-byte row segments);
* the output stored straight from the accumulators, two channels a store;
* chunk k + 3 loading (no product left in flight across chunks);
* a ring of 6 stages with chunk k + 4 loading.

Each variant is first held against ``conv_ref`` (``chip_smoke.CONV_TOL``)
at the kernel bench's shape, the edge cases and every ResNet-50 shape at
bs 32, at all four tiles.  Then, in turns (the order, then the order
reversed; CUDA events, L2 flushed), it times the bench shape (8, 32, 32,
128) x (3, 3, 128, 128) at every tile and the 53 convolutions of a
ResNet-50 forward at bs 128 at every tile and at the tile rule's
(``tiling.conv_tile_bf16``), beside ``F.conv2d`` in bf16 (cuDNN) on the
same inputs; last the card line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "conv_mm" / "csrc" / "conv_mm.cu"
OUT = ROOT / "build" / "conv_mm_variants"
TILES = ((64, 64), (64, 128), (128, 64), (128, 128))

DIRECT_EPILOGUE = """  // the first design's epilogue: pairs of channels straight from the
  // accumulators
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int row = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int o = o0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + 8 * h;
      if (m >= M || o >= g.O) continue;
      __nv_bfloat16* p = y + (int64_t)m * g.O + o;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (g.O % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __halves2bfloat162(__float2bfloat16(v0), __float2bfloat16(v1));
      } else {
        p[0] = __float2bfloat16(v0);
        if (o + 1 < g.O) p[1] = __float2bfloat16(v1);
      }
    }
  }
}
"""


def direct_epilogue(text: str) -> str:
    start = text.index("  __syncthreads();          // the ring is free")
    end = text.index("template <int BM, int BN, bool VEC_A>\ncudaError_t launch_bf16")
    return text[:start] + DIRECT_EPILOGUE + "\n" + text[end:]


def constant(name: str, value: int):
    def edit(text: str) -> str:
        new, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         text)
        if n != 1:
            raise SystemExit(f"the source no longer has one constexpr {name}")
        return new
    return edit


VARIANTS = {
    "kernel": [],
    "direct epilogue": [direct_epilogue],
    "ahead 3": [constant("kAhead16", 3)],
    "6 stages ahead 4": [constant("kStages16", 6), constant("kAhead16", 4)],
}


def build(name: str, edits) -> ctypes.CDLL:
    from chip_smoke import ptxas_kernels
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path

    text = SOURCE.read_text()
    for edit in edits:
        text = edit(text)
    stem = name.replace(" ", "_")
    cu, so = OUT / f"{stem}.cu", OUT / f"{stem}.so"
    cu.write_text(text)
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    regs = [f"{k} {r} registers, {s} B spilled"
            for k, r, s in ptxas_kernels(proc.stdout + proc.stderr) if "bf16" in k]
    print(f"build {name}: " + "; ".join(regs), flush=True)
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_mm_launch.argtypes = [vp] * 3 + [i] * 16 + [vp]
    lib.conv_mm_launch.restype = i
    return lib


def launch(lib, x, w, s, p, tile, y=None):
    import torch

    from repro_torch.kernels.conv_mm.ref import out_hw

    N, H, W, C = x.shape
    KH, KW, _, O = w.shape
    OH, OW = out_hw(H, W, KH, KW, s, p)
    if y is None:
        y = torch.empty((N, OH, OW, O), dtype=x.dtype, device=x.device)
    rc = lib.conv_mm_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), N, H, W, C, KH, KW, O, OH, OW, s, p, 1,
        *tile, int(C % 8 == 0 and x.data_ptr() % 16 == 0),
        int(O % 8 == 0 and w.data_ptr() % 16 == 0), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed (cudaError {rc})")
    return y


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels.conv_mm import tiling
    from repro_torch.kernels.conv_mm.ref import conv_ref, out_hw
    from repro_torch.models.cnn import build_resnet50

    if not torch.cuda.is_available():
        print("conv_mm_variants: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))

    counts: dict = {}
    for s_, node in cs.conv_nodes(build_resnet50(width_mult=1.0, input_hw=32)):
        counts[cs.conv_shape(s_, node)] = counts.get(cs.conv_shape(s_, node), 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    rtol, atol = cs.CONV_TOL["bfloat16"]
    cases = [cs.CONV_BENCH, *cs.CONV_EDGES, *((32, *k) for k in counts)]
    for name, lib in libs.items():
        worst = 0.0
        for N, H, W, C, K, O, s, p in cases:
            x, w = cs.conv_inputs(gen, N, H, W, C, K, O, torch.bfloat16)
            want = conv_ref(x, w, stride=s, padding=p).float()
            for tile in TILES:
                got = launch(lib, x, w, s, p, tile).float()
                diff = (got - want).abs()
                if not (torch.isfinite(got).all() and (diff <= atol + rtol * want.abs()).all()):
                    raise AssertionError(f"{name} disagrees at {(N, H, W, C, K, O, s, p)} "
                                         f"tile {tile}: {float(diff.max()):.3e}")
                worst = max(worst, float(diff.max()))
        print(f"check {name}: {len(cases)} shapes x {len(TILES)} tiles, max_abs_err "
              f"{worst:.3e} (rtol {rtol}, atol {atol})", flush=True)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def cudnn(x, w, s, p):
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        return lambda: F.conv2d(xc, wc, stride=s, padding=p)

    N, H, W, C, K, O, s, p = cs.CONV_BENCH
    bench = cs.conv_inputs(gen, N, H, W, C, K, O, torch.bfloat16)
    fwd = []
    for (H, W, C, K, O, s, p), n in counts.items():
        x, w = cs.conv_inputs(gen, 128, H, W, C, K, O, torch.bfloat16)
        OH, OW = out_hw(H, W, K, K, s, p)
        fwd.append((x, w, s, p, n, tiling.conv_tile_bf16(128 * OH * OW, O)))
    bound_ms, by, _ = cs.conv_bound(*cs.CONV_BENCH, "bfloat16")
    lib_ms = cs.time_ms(cudnn(*bench, 1, 1), flush)
    lib_fwd = sum(n * cs.time_ms(cudnn(x, w, s, p), flush, 10, 2) for x, w, s, p, n, _ in fwd)
    print(f"bench shape {cs.CONV_BENCH} bf16: F.conv2d (cuDNN) {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}); ResNet-50 forward bs 128 bf16: F.conv2d {lib_fwd:.4f} ms",
          flush=True)
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            lib = libs[name]
            y = launch(lib, *bench, 1, 1, (64, 128))
            b = [cs.time_ms(lambda: launch(lib, *bench, 1, 1, t, y), flush) for t in TILES]
            sums = {t: 0.0 for t in (*TILES, "rule")}
            for x, w, s, p, n, rule in fwd:
                y = launch(lib, x, w, s, p, rule)
                for t in (*TILES, "rule"):
                    tile = rule if t == "rule" else t
                    sums[t] += n * cs.time_ms(lambda: launch(lib, x, w, s, p, tile, y),
                                              flush, 10, 2)
            print(f"timing {name}: bench shape " + ", ".join(
                f"{t[0]}x{t[1]} {v:.4f}" for t, v in zip(TILES, b)) + " ms; ResNet-50 forward "
                "bs 128 " + ", ".join(f"{t if t == 'rule' else f'{t[0]}x{t[1]}'} {v:.4f}"
                                      for t, v in sums.items()) + " ms", flush=True)
    print(f"device {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
