#!/usr/bin/env python3
"""Speed of variants of the ``conv_mm`` kernels (implicit GEMMs on
``wgmma``), on one card.

    python3 scripts/conv_mm_variants.py                 # bf16
    python3 scripts/conv_mm_variants.py --f32 [--alt LABEL=PATH ...]

Builds variants of ``src/repro_torch/kernels/conv_mm/csrc/conv_mm.cu`` by
editing its text (into ``build/conv_mm_variants/``), each a library with
the kernel's own C interface, one ``nvcc`` each, all started together.

bf16 (``conv_mm_bf16_wgmma_kernel``):

* the kernel as it stands (a ring of 4 stages, chunk k + 2 loading while
  chunk k multiplies, the output tile staged in shared memory and stored
  in 16-byte row segments);
* the output stored straight from the accumulators, two channels a store;
* chunk k + 3 loading (no product left in flight across chunks);
* a ring of 6 stages with chunk k + 4 loading.

f32 (``conv_mm_tf32_wgmma_kernel``, 3xTF32, built at 64 x 64 and 128 x
128):

* the kernel as it stands (the truncating split, a ring of 4 stages);
* the rounding split (hi = x rounded to TF32, as ``ssd_chunk.cu``'s), for
  the A fragments and the w tile's K-major hi and lo parts;
* a ring of 3 stages;
* a fourth product, a_lo b_lo, before the other three;
* one chain: every product of K summed on the tensor cores into one
  accumulator (the first design), where the kernel sums a chunk's products
  there and adds each chunk's sum to the total in f32;
* per k-step sum: each k-step's 3 products summed there and added to the
  total in f32 (a shorter partial sum; the products wait a k-step each);
* mixed tiles: the kernel built at 64 x 128 and 128 x 64 too, the tiles
  ``tiling.conv_tile_bf16`` (the rule the f32 kernel had before its own)
  gives;
* timed only, with wrong results: one TF32 product a k-step, no
  products, no K-major rewrite of the w tile, products alone (no loads and
  no rewrite), products back to back (no loads, no rewrite, no wait or
  f32 add between chunks): what a chunk's time is made of;
* with ``--alt LABEL=PATH``, any other conv_mm source with the same C
  interface, checked and timed like a variant: another design of the
  kernel, or the CUDA-core kernel this one replaced (``git show
  b8b0b4f:src/repro_torch/kernels/conv_mm/csrc/conv_mm.cu >
  build/conv_mm_retired.cu``, then ``--alt "retired CUDA-core
  kernel=build/conv_mm_retired.cu"``).

Each variant (but the timing-only ones) is first held against ``conv_ref``
(``chip_smoke.CONV_TOL``) at the kernel bench's shape, the edge cases and
every ResNet-50 shape at bs 32, at every tile it takes; in f32 it then runs
``chip_smoke.cnn_step_check``'s card step through it (its relative errors
against the float64 step, and whether they hold the gates): the kernel,
the rounding split, the per k-step sum and the ``--alt`` sources at the 5
seeds of ``SEEDS`` (the spread of the momentum's error against its gate),
the others at seed 0.  Then, in turns (the order, then the order
reversed; CUDA events, L2 flushed), it times the bench shape (8, 32, 32,
128) x (3, 3, 128, 128) at every tile a library takes and the 53
convolutions of a ResNet-50 forward at bs 128 at those tiles, at the tile
rule's (``tiling.tile_for``) and, in f32 where the library takes it, at the
old rule's (``conv_tile_bf16``), beside ``F.conv2d`` in the same type
(cuDNN, TF32 off) on the same inputs and the bounds.  In f32 also: the
kernel built at every tile ("mixed tiles") at each tile for each of the 23
shapes (the rule's tile starred) and the sum of each shape's fastest tile;
the new tile rule against the old at every (batch size, convolution) pair
of ``chip_smoke.py``'s cnn grid and engine sub-networks where the two
differ (sums plain and over those pairs' launches), and every tile at the
pairs around the rule's threshold (65-127 blocks of 128 x 128); last the
card line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
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
F32_TILES = ((64, 64), (128, 128))           # the f32 kernel's only tiles
SEEDS = range(5)                              # of the step check, where it reads several

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

ROUNDING_SPLIT = """  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));"""


def replace(old: str, new: str):
    def edit(text: str) -> str:
        if text.count(old) != 1:
            raise SystemExit(f"the source no longer has one {old!r}")
        return text.replace(old, new)
    return edit


F32_DISPATCH = """  if (bm == 128 && bn == 128)
    return (int)launch_tf32_tile<128, 128>(xf, wf, yf, g, vec_a, vec_b, s);
  if (bm == 64 && bn == 64)
    return (int)launch_tf32_tile<64, 64>(xf, wf, yf, g, vec_a, vec_b, s);
"""
PRODUCTS = """      WgmmaTf32<BN>::rs(part, al[kk], b_hi, kk > 0);
      WgmmaTf32<BN>::rs(part, ah[kk], b_lo, 1);
      WgmmaTf32<BN>::rs(part, ah[kk], b_hi, 1);
    }
    wgmma_commit();
"""
PER_K_STEP = """      WgmmaTf32<BN>::rs(part, al[kk], b_hi, 0);
      WgmmaTf32<BN>::rs(part, ah[kk], b_lo, 1);
      WgmmaTf32<BN>::rs(part, ah[kk], b_hi, 1);
      if (kk + 1 < kBK32 / 8) {      // each k-step's 3 products join acc alone
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
        wgmma_fence();
      }
    }
    wgmma_commit();
"""

F32_VARIANTS = {
    "kernel": [],
    "rounding split": [replace("""  hi = x & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));""", ROUNDING_SPLIT)],
    "3 stages": [constant("kStages32", 3)],
    "4 products": [replace("      WgmmaTf32<BN>::rs(part, al[kk], b_hi, kk > 0);\n",
                           "      WgmmaTf32<BN>::rs(part, al[kk], b_lo, kk > 0);\n"
                           "      WgmmaTf32<BN>::rs(part, al[kk], b_hi, 1);\n")],
    "one chain": [replace("    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];\n"
                          "    // the chunk's A fragments, split\n",
                          "    // the chunk's A fragments, split\n"),
                  replace("b_hi, kk > 0);", "b_hi, 1);")],
    "per k-step sum": [replace(PRODUCTS, PER_K_STEP)],
    # the kernel built at the mixed tiles too, which conv_tile_bf16 (the
    # rule the f32 kernel had before its own) gives
    "mixed tiles": [replace(F32_DISPATCH, F32_DISPATCH.replace(
        "  if (bm == 64 && bn == 64)",
        "  if (bm == 128 && bn == 64)\n"
        "    return (int)launch_tf32_tile<128, 64>(xf, wf, yf, g, vec_a, vec_b, s);\n"
        "  if (bm == 64 && bn == 128)\n"
        "    return (int)launch_tf32_tile<64, 128>(xf, wf, yf, g, vec_a, vec_b, s);\n"
        "  if (bm == 64 && bn == 64)"))],
}
# f32 variants whose card step is read at every seed of SEEDS (the others at 0)
F32_SEEDED = ("kernel", "rounding split", "per k-step sum")

# f32 ablations: wrong results, timed only, to show what a chunk's time is made of
F32_ABLATIONS = {
    "1 product (timing only)": [
        replace("      WgmmaTf32<BN>::rs(part, al[kk], b_hi, kk > 0);\n"
                "      WgmmaTf32<BN>::rs(part, ah[kk], b_lo, 1);\n"
                "      WgmmaTf32<BN>::rs(part, ah[kk], b_hi, 1);\n",
                "      WgmmaTf32<BN>::rs(part, ah[kk], b_hi, kk > 0);\n")],
    "no products (timing only)": [
        replace("      WgmmaTf32<BN>::rs(part, al[kk], b_hi, kk > 0);\n"
                "      WgmmaTf32<BN>::rs(part, ah[kk], b_lo, 1);\n"
                "      WgmmaTf32<BN>::rs(part, ah[kk], b_hi, 1);\n", "")],
    "no w rewrite (timing only)": [replace("      if (q < 2 * BN) {", "      if (q < 0) {")],
    "products only (timing only)": [
        replace("      if (q < 2 * BN) {", "      if (q < 0) {"),
        replace("    if (kc + kStages32 - 1 < n_chunks)\n"
                "      load((kc + kStages32 - 1) % kStages32, kc + kStages32 - 1);\n", "")],
    "products back to back (timing only)": [
        replace("      if (q < 2 * BN) {", "      if (q < 0) {"),
        replace("    if (kc + kStages32 - 1 < n_chunks)\n"
                "      load((kc + kStages32 - 1) % kStages32, kc + kStages32 - 1);\n", ""),
        replace("  uint32_t ah[4][4], al[4][4];", "  uint32_t ah[4][4] = {}, al[4][4] = {};"),
        lambda text: text[:text.index("    wgmma_wait<0>();        // chunk kc - 1's products")]
        + text[text.index("    fence_proxy_async();\n    __syncthreads();        // hi and lo"):]],
}


def build(name: str, edits, kind: str, source: Path = SOURCE) -> ctypes.CDLL:
    from chip_smoke import ptxas_kernels
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path

    text = source.read_text()
    for edit in edits:
        text = edit(text)
    stem = name.replace(" ", "_")
    cu, so = OUT / f"{stem}.cu", OUT / f"{stem}.so"
    cu.write_text(text)
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    log = proc.stdout + proc.stderr
    regs = [f"{k} {r} registers, {s} B spilled"
            for k, r, s in ptxas_kernels(log) if kind in k]
    notes = [line.strip() for line in log.splitlines() if "arning" in line]
    print(f"build {name}: " + "; ".join(regs) + "".join(f"\n  {n}" for n in notes[:8]),
          flush=True)
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
    per16 = 16 // x.element_size()          # values in one 16-byte copy
    if y is None:
        y = torch.empty((N, OH, OW, O), dtype=x.dtype, device=x.device)
    rc = lib.conv_mm_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), N, H, W, C, KH, KW, O, OH, OW, s, p,
        int(x.dtype == torch.bfloat16), *tile, int(C % per16 == 0 and x.data_ptr() % 16 == 0),
        int(O % per16 == 0 and w.data_ptr() % 16 == 0), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed (cudaError {rc})")
    return y


def sass_outline(so: Path, kernel: str) -> None:
    """The order of the tensor-core, barrier, wait and shared-memory
    instructions in one instantiation's SASS (``cuobjdump -sass``), runs of
    one opcode folded: where the compiler waits for the products."""
    import os
    import shutil

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.isfile(tool) else shutil.which("cuobjdump")
    if not tool:
        print("sass: no cuobjdump")
        return
    from chip_smoke import kernel_name

    out = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True).stdout
    keep = ("HGMMA", "WARPGROUP", "DEPBAR", "BAR.", "LDSM", "LDGSTS", "LDS.", "STS.", "BRA",
            "FADD", "WARPSYNC")
    ops, name = [], None
    for line in out.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :")[1].strip())
            continue
        if name != kernel:
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
        if m and any(m.group(2).startswith(k) for k in keep):
            op = m.group(2)
            if ops and ops[-1][0] == op:
                ops[-1][1] += 1
            else:
                ops.append([op, 1])
    print(f"sass {kernel}: " + " ".join(f"{op}x{n}" if n > 1 else op for op, n in ops),
          flush=True)


def step_check(name: str, lib, seeds=(0,)) -> None:
    """``chip_smoke.cnn_step_check`` with ``lib`` as the kernel's library,
    at each of ``seeds`` (weights and batch); with several, the spread of
    the momentum's relative error against its gate."""
    import chip_smoke as cs
    from repro_torch.kernels.conv_mm.kernel import conv_mm_cuda

    conv_mm_cuda.load()
    kept, conv_mm_cuda._lib = conv_mm_cuda._lib, lib
    momentum, failed = [], []
    try:
        for seed in seeds:
            try:
                momentum.append(cs.cnn_step_check(seed)["momentum"])
            except AssertionError as e:
                failed.append(seed)
                print(f"step {name} seed {seed}: fails, {e}", flush=True)
    finally:
        conv_mm_cuda._lib = kept
    verdict = "holds the gates" if not failed else f"fails at seeds {failed}"
    spread = (f"; momentum error over the {len(momentum)} passing seeds min "
              f"{min(momentum):.3e}, max {max(momentum):.3e} (gate {cs.STEP_GRAD_TOL:.1e}, "
              f"{1 - max(momentum) / cs.STEP_GRAD_TOL:.1%} headroom at the max)"
              if len(seeds) > 1 and momentum else "")
    print(f"step {name} at seeds {list(seeds)}: {verdict}{spread}", flush=True)


def profiled_pairs() -> dict:
    """(batch size, H, W, C, K, O, stride, padding) -> launches on the main
    path's profiling runs (``chip_smoke.py``'s cnn grid, 9 steps a profile,
    and the engine phase's 16 sub-networks, 14 steps a profile; the
    search's winners, unknown before it runs, left out)."""
    import numpy as np

    import chip_smoke as cs
    from repro_torch.bench.common import GRID_BS
    from repro_torch.bench.table2_case_study import (INFER_BS, N_TEST_SUB, N_TRAIN_SUB,
                                                     TRAIN_BS)
    from repro_torch.core.dataset import (DEFAULT_TEST_LEVELS, PAPER_TRAIN_LEVELS,
                                          GridSpec, _build_pruned)
    from repro_torch.core.search import sample_subnetwork
    from repro_torch.models.cnn import build_resnet50

    grids = [GridSpec("resnet50", PAPER_TRAIN_LEVELS, "random", GRID_BS, 1.0, 32),
             GridSpec("resnet50", DEFAULT_TEST_LEVELS, "random", GRID_BS, 1.0, 32),
             GridSpec("resnet50", DEFAULT_TEST_LEVELS, "l1", GRID_BS, 1.0, 32)]
    base = build_resnet50(width_mult=1.0, input_hw=32)
    subs = [build_resnet50(widths=sample_subnetwork(base.widths, np.random.default_rng(2000 + i)),
                           input_hw=32) for i in range(N_TRAIN_SUB + N_TEST_SUB)]
    runs = ([(_build_pruned(g, lv), GRID_BS, 2 + 2 + 5) for g in grids for lv in g.levels]
            + [(m, (*INFER_BS, TRAIN_BS), cs.PROFILE_STEPS) for m in subs])
    pairs: dict = {}
    for m, sizes, steps in runs:
        for c in cs.conv_nodes(m):
            for bs in sizes:
                key = (bs, *cs.conv_shape(*c))
                pairs[key] = pairs.get(key, 0) + steps
    return pairs


def rule_timing(new_lib, mixed_lib, flush) -> None:
    """The f32 tile rule (``tiling.conv_tile``) against the rule it replaced
    (``conv_tile_bf16``'s) at every (batch size, convolution) pair of the
    main path's profiling runs where the two differ, each pair timed at
    both; the sums over those pairs, plain and weighted by the pair's
    launches; then every tile at the pairs whose 128 x 128 grid has 65-127
    blocks and O > 64; last 64 x 64 against 128 x 128 across the rule's
    boundary (the 64 x 64 grid 248-320 blocks, two an SM taking 264), at a
    1 x 1 and a 3 x 3 convolution of O 128 on 8 x 8 images."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.conv_mm import tiling
    from repro_torch.kernels.conv_mm.ref import out_hw

    pairs = profiled_pairs()
    gen = torch.Generator(device="cuda").manual_seed(4)
    total = sum(pairs.values())
    differ, mid = [], []
    for key in sorted(pairs):
        N, H, W, C, K, O, s, p = key
        OH, OW = out_hw(H, W, K, K, s, p)
        M = N * OH * OW
        new, old = tiling.conv_tile(M, O), tiling.conv_tile_bf16(M, O)
        if new != old:
            differ.append((key, new, old))
        if O > 64 and 65 <= -(-M // 128) * -(-O // 128) <= 127:
            mid.append(key)
    sums = {"new": 0.0, "old": 0.0, "new_w": 0.0, "old_w": 0.0}
    by_tiles: dict = {}
    for key, new, old in differ:
        N, H, W, C, K, O, s, p = key
        x, w = cs.conv_inputs(gen, N, H, W, C, K, O, torch.float32)
        y = launch(new_lib, x, w, s, p, new)
        t_new = cs.time_ms(lambda: launch(new_lib, x, w, s, p, new, y), flush, 5, 1)
        t_old = cs.time_ms(lambda: launch(mixed_lib, x, w, s, p, old, y), flush, 5, 1)
        n = pairs[key]
        sums["new"] += t_new
        sums["old"] += t_old
        sums["new_w"] += n * t_new / 1e3
        sums["old_w"] += n * t_old / 1e3
        agg = by_tiles.setdefault((new, old), [0, 0.0, 0.0])
        agg[0] += 1
        agg[1] += t_new
        agg[2] += t_old
    share = sum(pairs[k] for k, _, _ in differ) / total
    print(f"rule: {len(pairs)} distinct (batch size, convolution) pairs on the main path's "
          f"profiling runs ({total} launches); the rules differ at {len(differ)} pairs "
          f"({share:.1%} of the launches): sum of one launch each, new rule {sums['new']:.3f} ms, "
          f"old rule {sums['old']:.3f} ms (old / new {sums['old'] / sums['new']:.3f}); "
          f"over the main path's launches at those pairs new {sums['new_w']:.3f} s, old "
          f"{sums['old_w']:.3f} s (old / new {sums['old_w'] / sums['new_w']:.3f})", flush=True)
    for (new, old), (n, t_new, t_old) in sorted(by_tiles.items()):
        print(f"rule: new {new[0]}x{new[1]} where the old gave {old[0]}x{old[1]}: {n} pairs, "
              f"new {t_new:.3f} ms, old {t_old:.3f} ms (old / new {t_old / t_new:.3f})",
              flush=True)
    wins = {t: 0 for t in TILES}
    for key in mid:
        N, H, W, C, K, O, s, p = key
        OH, OW = out_hw(H, W, K, K, s, p)
        M = N * OH * OW
        x, w = cs.conv_inputs(gen, N, H, W, C, K, O, torch.float32)
        y = launch(mixed_lib, x, w, s, p, (64, 64))
        ms = {t: cs.time_ms(lambda: launch(mixed_lib, x, w, s, p, t, y), flush, 10, 2)
              for t in TILES}
        best = min(ms, key=ms.get)
        wins[best] += 1
        new = tiling.conv_tile(M, O)
        print(f"rule mid N={N} {H}x{W} C={C} K={K} O={O} s={s} p={p}: "
              f"{-(-M // 128) * -(-O // 128)} blocks of 128 x 128; " + ", ".join(
                  f"{t[0]}x{t[1]}{'*' if t == new else ''} {v:.4f}" for t, v in ms.items())
              + f" ms; new rule / fastest {ms[new] / ms[best]:.3f}", flush=True)
    print(f"rule mid: {len(mid)} pairs of 65-127 blocks of 128 x 128, fastest tile counts "
          + ", ".join(f"{t[0]}x{t[1]} {n}" for t, n in wins.items()), flush=True)
    for C, K, p in ((256, 1, 0), (128, 3, 1)):
        cells = []
        for N in (124, 128, 132, 133, 136, 140, 148, 160):    # 64 x 64 grid 2N
            x, w = cs.conv_inputs(gen, N, 8, 8, C, K, 128, torch.float32)
            y = launch(new_lib, x, w, 1, p, (64, 64))
            ms = [cs.time_ms(lambda: launch(new_lib, x, w, 1, p, t, y), flush, 10, 2)
                  for t in F32_TILES]
            rule = tiling.conv_tile(N * 64, 128)
            cells.append(f"{2 * N} blocks {ms[0]:.4f} / {ms[1]:.4f}"
                         f"{' (rule 128x128)' if rule == (128, 128) else ''}")
        print(f"rule boundary C={C} K={K} O=128 8x8, 64x64 / 128x128 ms by 64 x 64 grid: "
              + "; ".join(cells), flush=True)


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels.conv_mm import tiling
    from repro_torch.kernels.conv_mm.ref import conv_ref, out_hw
    from repro_torch.models.cnn import build_resnet50

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f32", action="store_true", help="the f32 (3xTF32) kernel's variants")
    ap.add_argument("--alt", action="append", default=[], metavar="LABEL=PATH",
                    help="with --f32: another conv_mm.cu to check and time beside the kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_mm_variants: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.float32 if args.f32 else torch.bfloat16
    name_t = "float32" if args.f32 else "bfloat16"
    kind = "f32" if args.f32 else "bf16"
    jobs = [(n, e, kind, SOURCE) for n, e in (F32_VARIANTS if args.f32 else VARIANTS).items()]
    if args.f32:
        jobs += [(label, [], kind, Path(path).resolve())
                 for label, path in (a.split("=", 1) for a in args.alt)]
        jobs += [(n, e, kind, SOURCE) for n, e in F32_ABLATIONS.items()]
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip((j[0] for j in jobs), pool.map(lambda j: build(*j), jobs)))
    if args.f32:
        for name in libs:
            if name in F32_VARIANTS:
                sass_outline(OUT / f"{name.replace(' ', '_')}.so",
                             "conv_mm_tf32_wgmma_kernel<128, 128, 1>")
    # the tiles each library takes: the f32 kernel and its variants the two
    # square ones, but for "mixed tiles" and the other sources (--alt)
    tiles = {name: F32_TILES if args.f32 and name in {**F32_VARIANTS, **F32_ABLATIONS}
             and name != "mixed tiles" else TILES for name in libs}

    counts: dict = {}
    for s_, node in cs.conv_nodes(build_resnet50(width_mult=1.0, input_hw=32)):
        counts[cs.conv_shape(s_, node)] = counts.get(cs.conv_shape(s_, node), 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    rtol, atol = cs.CONV_TOL[name_t]
    cases = [cs.CONV_BENCH, *cs.CONV_EDGES, *((32, *k) for k in counts)]
    for name, lib in libs.items():
        if name in F32_ABLATIONS:
            continue
        worst = 0.0
        for N, H, W, C, K, O, s, p in cases:
            x, w = cs.conv_inputs(gen, N, H, W, C, K, O, dtype)
            want = conv_ref(x, w, stride=s, padding=p).float()
            for tile in tiles[name]:
                got = launch(lib, x, w, s, p, tile).float()
                diff = (got - want).abs()
                if not (torch.isfinite(got).all() and (diff <= atol + rtol * want.abs()).all()):
                    raise AssertionError(f"{name} disagrees at {(N, H, W, C, K, O, s, p)} "
                                         f"tile {tile}: {float(diff.max()):.3e}")
                worst = max(worst, float(diff.max()))
        print(f"check {name}: {len(cases)} shapes x {len(tiles[name])} tiles, max_abs_err "
              f"{worst:.3e} (rtol {rtol}, atol {atol})", flush=True)
        if args.f32:
            step_check(name, lib, SEEDS if name in F32_SEEDED or name not in F32_VARIANTS
                       else (0,))

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def cudnn(x, w, s, p):
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        return lambda: F.conv2d(xc, wc, stride=s, padding=p)

    N, H, W, C, K, O, s, p = cs.CONV_BENCH
    bench = cs.conv_inputs(gen, N, H, W, C, K, O, dtype)
    fwd, bound, bound_tc = [], 0.0, 0.0
    for (H, W, C, K, O, s, p), n in counts.items():
        x, w = cs.conv_inputs(gen, 128, H, W, C, K, O, dtype)
        OH, OW = out_hw(H, W, K, K, s, p)
        fwd.append((x, w, s, p, n, tiling.tile_for(128 * OH * OW, O, dtype),
                    tiling.conv_tile_bf16(128 * OH * OW, O)))
        b, _ = cs.conv_bound(128, H, W, C, K, O, s, p, name_t)
        b_tc, _ = cs.conv_bound(128, H, W, C, K, O, s, p, name_t, tc=True)
        bound, bound_tc = bound + n * b, bound_tc + n * b_tc
    bench_bound, by = cs.conv_bound(*cs.CONV_BENCH, name_t)
    bench_tc, _ = cs.conv_bound(*cs.CONV_BENCH, name_t, tc=True)
    lib_ms = cs.time_ms(cudnn(*bench, 1, 1), flush)
    lib_fwd = sum(n * cs.time_ms(cudnn(x, w, s, p), flush, 10, 2)
                  for x, w, s, p, n, *_ in fwd)
    tc = (f" (CUDA cores; 3xTF32 on the tensor cores {bench_tc:.4f} ms)" if args.f32 else "")
    tc_fwd = (f" (CUDA cores; 3xTF32 on the tensor cores {bound_tc:.4f} ms)" if args.f32
              else "")
    print(f"bench shape {cs.CONV_BENCH} {kind}: F.conv2d (cuDNN, no TF32) {lib_ms:.4f} ms, "
          f"bound {bench_bound:.4f} ms ({by}){tc}; ResNet-50 forward bs 128 {kind}: F.conv2d "
          f"{lib_fwd:.4f} ms, bound {bound:.4f} ms{tc_fwd}", flush=True)
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            lib, mine = libs[name], tiles[name]
            y = launch(lib, *bench, 1, 1, (64, 64))
            b = [cs.time_ms(lambda: launch(lib, *bench, 1, 1, t, y), flush) for t in mine]
            # "old rule": conv_tile_bf16's tile, where the library takes it
            rules = ("rule", "old rule") if args.f32 and len(mine) == len(TILES) else ("rule",)
            sums = {t: 0.0 for t in (*mine, *rules)}
            for x, w, s, p, n, rule, old in fwd:
                y = launch(lib, x, w, s, p, rule)
                for t in sums:
                    tile = {"rule": rule, "old rule": old}.get(t, t)
                    sums[t] += n * cs.time_ms(lambda: launch(lib, x, w, s, p, tile, y),
                                              flush, 10, 2)
            print(f"timing {name}: bench shape " + ", ".join(
                f"{t[0]}x{t[1]} {v:.4f}" for t, v in zip(mine, b)) + " ms; ResNet-50 forward "
                "bs 128 " + ", ".join(f"{t if isinstance(t, str) else f'{t[0]}x{t[1]}'} {v:.4f}"
                                      for t, v in sums.items()) + " ms", flush=True)
    if args.f32:
        lib, best = libs["mixed tiles"], 0.0
        for (H, W, C, K, O, s, p), (x, w, _, _, n, rule, _) in zip(counts, fwd):
            y = launch(lib, x, w, s, p, rule)
            ms = [cs.time_ms(lambda: launch(lib, x, w, s, p, t, y), flush, 10, 2) for t in TILES]
            tc, _ = cs.conv_bound(128, H, W, C, K, O, s, p, name_t, tc=True)
            best += n * min(ms)
            print(f"shape x{n} N=128 {H}x{W} C={C} K={K} O={O} s={s} p={p}: " + ", ".join(
                f"{t[0]}x{t[1]}{'*' if t == rule else ''} {v:.4f}" for t, v in zip(TILES, ms))
                + f" ms; 3xTF32 bound {tc:.4f} ms", flush=True)
        print(f"kernel (built at every tile) ResNet-50 forward bs 128 at each shape's fastest "
              f"tile {best:.4f} ms", flush=True)
        rule_timing(libs["kernel"], libs["mixed tiles"], flush)
    print(f"device {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
