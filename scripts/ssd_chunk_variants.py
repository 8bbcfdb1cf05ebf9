#!/usr/bin/env python3
"""Speed of variants of the SSD intra-chunk kernel, on one card.

    python3 scripts/ssd_chunk_variants.py

Builds variants of ``src/repro_torch/kernels/ssm_scan/csrc/ssd_chunk.cu``
by editing its text (into ``build/ssd_chunk_variants/``), each a library
with the kernel's own C interface:

* 8 warps a block in place of 16;
* y units 16 columns wide in place of 32 (twice the units, so the
  triangle's rows pair up over 16 warps at chunk 128);
* 4 or 8 heads a block in place of 6 (more blocks, or fewer C·Bᵀ builds).

At mamba2-780m's SSD layer (B 1, S 2048, 48 heads, P 64, N 128, f32,
inputs drawn as ``chip_smoke.py`` draws them) each variant is first held
against the plain version at chunks 64 and 128 (the outputs within
``chip_smoke.SSD_TOL``), then all are timed in turns (CUDA events, L2
flushed by a 256 MB write; the order, then the order reversed) at both
chunks.  Prints one line per measurement and the card line.  Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
OUT = ROOT / "build" / "ssd_chunk_variants"

GROUP = "constexpr int kGroup = 6; "
VARIANTS = {
    "8 warps": [("constexpr int kThreads = 512;", "constexpr int kThreads = 256;")],
    "16-column y units": [("constexpr int kYTiles = 4; ", "constexpr int kYTiles = 2; ")],
    "4 heads a block": [(GROUP, GROUP.replace("6", "4"))],
    "8 heads a block": [(GROUP, GROUP.replace("6", "8"))],
}
CHUNKS = (64, 128)


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.ssm_scan.kernel import SOURCES, SsdChunkKernel
    from repro_torch.kernels.ssm_scan.ref import ssd_chunk_ref

    if not torch.cuda.is_available():
        print("ssd_chunk_variants: CUDA is not available", file=sys.stderr)
        return 1
    text = SOURCES[0].read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    kernels = {"as is": SsdChunkKernel()}
    for i, (label, edits) in enumerate(VARIANTS.items()):
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {label!r}: edit target not found")
            src = src.replace(old, new)
        path = OUT / f"variant{i}.cu"
        path.write_text(src)
        kernels[label] = SsdChunkKernel(f"ssd_chunk_variant{i}", [path])
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.load(), kernels.values()))
    for label, k in kernels.items():
        log = Path(k._lib._name).with_suffix(".log").read_text()
        print(f"{label}: ptxas {cs.ptxas_summary(log)}")

    gen = torch.Generator(device="cuda").manual_seed(3)
    B, S, H, P, N = (cs.SSD_SHAPE[k] for k in ("B", "S", "H", "P", "N"))
    xh = torch.randn(B, S, H, P, generator=gen, device="cuda")
    a = -torch.randn(B, S, H, generator=gen, device="cuda").abs() * 0.1
    Bm = torch.randn(B, S, N, generator=gen, device="cuda")
    Cm = torch.randn(B, S, N, generator=gen, device="cuda")
    for ch in CHUNKS:
        want = ssd_chunk_ref(xh, a, Bm, Cm, chunk=ch)
        for label, k in kernels.items():
            got = k(xh, a, Bm, Cm, chunk=ch)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            print(f"{label} chunk={ch}: max_abs_err over the four outputs {err:.3e}")
            if not err <= cs.SSD_TOL:
                raise AssertionError(f"variant {label} disagrees at chunk {ch}")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    order = list(kernels)
    for ch in CHUNKS:
        times = {label: [] for label in order}
        for turn in (order, order[::-1]):
            for label in turn:
                times[label].append(cs.time_ms(
                    lambda: kernels[label](xh, a, Bm, Cm, chunk=ch), flush, 20, 3))
        print(f"turns chunk={ch}: " + ", ".join(
            f"{label} " + " / ".join(f"{t:.4f}" for t in ts) for label, ts in times.items()))
    print(f"device {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
