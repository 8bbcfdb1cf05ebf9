#!/usr/bin/env python3
"""What holds the bf16 paged-decode kernel back, on one card.

    python3 scripts/paged_decode_variants.py

At the kernel cell of ``chip_smoke.py`` (qwen3-4b decode: B 8, H 32 over 8
KV heads, Dh 128, pool blocks of 256, tables of 8 blocks, bf16, ragged
fills drawn as chip_smoke.py draws them, 7482 live tokens) it times:

* the kernel as it stands, at each token tile and split, with the L2 cache
  flushed by a 256 MB write before every call (``chip_smoke.time_ms``), and
  flushed by a 256 MB read instead (no dirty lines left for the kernel's
  reads to write back).  Without a flush the card would wait for the host
  to enqueue each call, and the interval would time the host;
* a yardstick for the same bytes: ``torch.sum`` over 30.6 MB of
  contiguous bf16, under both flushes;
* variants of ``csrc/paged_decode.cu`` built by text edits into
  ``build/paged_decode_variants/``, each a library with the kernel's own C
  interface: 8 warps a block for tiles of 128 tokens and more (the kernel:
  4), and rings of 2 and 4 stages (the kernel: 3; 4 stages do not fit a
  128-token tile at Dh 128).  Each variant is checked against the plain
  version first, then timed in turns with the kernel as it stands (the
  order, then the order reversed; write flush).

Prints one line per measurement and the card line.  Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
OUT = ROOT / "build" / "paged_decode_variants"

WARPS = ("__host__ __device__ constexpr int tc_warps(int tk) { return tk >= 64 ? 4 : tk / 16; }",
         "__host__ __device__ constexpr int tc_warps(int tk) "
         "{ return tk >= 128 ? 8 : tk >= 64 ? 4 : tk / 16; }")
STAGES = "constexpr int kStages = 3;          // ring stages of K and V tiles"
VARIANTS = {
    "8 warps at tiles >= 128": [WARPS],
    "2 stages": [(STAGES, STAGES.replace("3;", "2;"))],
    "4 stages": [(STAGES, STAGES.replace("3;", "4;"))],
}
CONFIGS = [(64, 1), (64, 4), (128, 1), (128, 2), (128, 4), (32, 8)]


def time_with(fn, before, reps: int = 30, warmup: int = 5) -> float:
    """Median ms of one call by CUDA events, ``before()`` ahead of each."""
    import torch

    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.paged_decode.kernel import SOURCES, PagedDecodeKernel
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref

    if not torch.cuda.is_available():
        print("paged_decode_variants: CUDA is not available", file=sys.stderr)
        return 1
    text = SOURCES[0].read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    kernels = {"as is": PagedDecodeKernel()}
    for i, (label, edits) in enumerate(VARIANTS.items()):
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {label!r}: edit target not found")
            src = src.replace(old, new)
        path = OUT / f"variant{i}.cu"
        path.write_text(src)
        kernels[label] = PagedDecodeKernel(f"paged_decode_variant{i}", [path])
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.load(), kernels.values()))

    fills = np.random.default_rng(1).integers(64, 1537, cs.DECODE["B"]) + 16
    args = cs.decode_case(torch.bfloat16, cs.DECODE["Dh"], fills.tolist(), seed=1)
    want = paged_decode_ref(*args).float()
    bound_ms, _ = cs.bound(args[0], args[1], args[4])
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    modes = {"write flush": flush.zero_, "read flush": lambda: flush.max()}
    live = int((args[4].long() + 1).sum())
    same_bytes = torch.zeros(2 * live * cs.DECODE["Hkv"] * cs.DECODE["Dh"],
                             dtype=torch.bfloat16, device="cuda")
    print(f"kernel cell: {live} live tokens, {same_bytes.numel() * 2 / 1e6:.1f} MB of K/V, "
          f"bound {bound_ms:.4f} ms")
    for mode, before in modes.items():
        print(f"torch.sum over the same bytes, {mode}: "
              f"{time_with(same_bytes.sum, before):.4f} ms")
    for bkv, ns in CONFIGS:
        fn = lambda: kernels["as is"](*args, block_kv=bkv, n_splits=ns)
        print(f"as is block_kv={bkv} n_splits={ns}: " + ", ".join(
            f"{mode} {time_with(fn, before):.4f} ms" for mode, before in modes.items()))

    order = list(kernels)
    for label in order[1:]:
        k = kernels[label]
        errs = []
        for bkv, ns in CONFIGS:
            try:
                got = k(*args, block_kv=bkv, n_splits=ns)
            except RuntimeError:
                errs.append(None)
                continue
            torch.cuda.synchronize()
            errs.append(float((got.float() - want).abs().max()))
        print(f"variant {label}: max_abs_err vs plain by config " + ", ".join(
            f"{c}: {'does not launch' if e is None else f'{e:.2e}'}"
            for c, e in zip(CONFIGS, errs)))
        if any(e is not None and not e <= cs.TOL["bfloat16"] for e in errs):
            raise AssertionError(f"variant {label} disagrees with the plain version")
    for bkv, ns in CONFIGS:
        times = {label: [] for label in order}
        for turn in (order, order[::-1]):
            for label in turn:
                try:
                    times[label].append(time_with(
                        lambda: kernels[label](*args, block_kv=bkv, n_splits=ns),
                        flush.zero_))
                except RuntimeError:
                    pass
        print(f"turns block_kv={bkv} n_splits={ns} (write flush): " + ", ".join(
            f"{label} " + ("-" if not t else " / ".join(f"{x:.4f}" for x in t))
            for label, t in times.items()))
    print(f"device {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
