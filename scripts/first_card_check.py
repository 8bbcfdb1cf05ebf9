#!/usr/bin/env python3
"""A short first card call for the bf16 paged-decode and SSD kernels.

    python3 scripts/first_card_check.py

Builds both libraries (one ``nvcc`` each, together) and prints ptxas's
registers and spills per instantiation and the SASS tensor-core
instruction counts; holds bf16 paged decode against its plain version at
the cache_len edges of ``chip_smoke.py`` for Dh 128 and 64, rep 4, 1, 5
and 8, every token tile 16-256 (a tile whose ring does not fit prints
"-") and 1, 2, 4 and 8 splits; times it at the kernel cell at each tile
and split (L2 flushed), beside gather + SDPA and the CUDA-core kernel
(f32 q); holds the SSD pass against its plain version at mamba2-780m's
shape for chunks 16-128, f32 and bf16 inputs, and times it at chunks 32,
64 and 128.  Prints FAILURES [] when every check holds.  About 40 s of
command, where ``chip_smoke.py`` takes minutes: the check to run first
after a change to either source.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.paged_decode import kernel as pdk
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref
    from repro_torch.kernels.ssm_scan import kernel as ssk
    from repro_torch.kernels.ssm_scan.ref import ssd_chunk_ref

    if not torch.cuda.is_available():
        print("first_card_check: CUDA is not available", file=sys.stderr)
        return 1
    print(cs.card_line(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(lambda w: w.load(), (pdk.paged_decode_cuda, ssk.ssd_chunk_cuda)))
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs:
        log = Path(lib._name).with_suffix(".log").read_text()
        print(Path(lib._name).name, cs.ptxas_summary(log))
        for k, r, s in cs.ptxas_kernels(log):
            print("   ", k, r, "regs", s, "spill")
        print("   SASS", cs.sass_mma_count(lib._name))
        for line in log.splitlines():
            if "arning" in line or "error" in line:
                print("   ", line[:300])

    failures = []
    bs, NB = 256, 8
    edges = [0, bs - 1, bs, 2 * bs - 1, 3 * bs, 5 * bs + 17, NB * bs - 1, 700]
    for Dh in (128, 64):
        for H, Hkv in ((32, 8), (32, 32), (40, 8), (32, 4)):
            args = cs.decode_case(torch.bfloat16, Dh, edges, H=H, Hkv=Hkv)
            want = paged_decode_ref(*args).float()
            errs = []
            for bkv in (16, 32, 64, 128, 256):
                for ns in (1, 2, 4, 8):
                    try:
                        got = pdk.paged_decode_cuda(*args, block_kv=bkv, n_splits=ns)
                        torch.cuda.synchronize()
                        err = float((got.float() - want).abs().max())
                    except ValueError:         # the ring does not fit
                        err = None
                    errs.append((bkv, ns, err))
                    if err is not None and not err <= cs.TOL["bfloat16"]:
                        failures.append(("pd", Dh, H, Hkv, bkv, ns, err))
            print(f"pd Dh={Dh} H={H} Hkv={Hkv}: " + " ".join(
                f"{b}/{n}:{'-' if e is None else f'{e:.1e}'}" for b, n, e in errs), flush=True)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    fills = np.random.default_rng(1).integers(64, 1537, 8) + 16
    args = cs.decode_case(torch.bfloat16, 128, fills.tolist(), seed=1)
    bnd = cs.bound(args[0], args[1], args[4])
    print("bound", bnd)
    for bkv in (16, 32, 64, 128):
        row = []
        for ns in (1, 2, 4, 8):
            row.append(cs.time_ms(lambda: pdk.paged_decode_cuda(*args, block_kv=bkv, n_splits=ns), flush))
        print(f"pd timing bkv={bkv}: " + " ".join(f"{t:.4f}" for t in row), flush=True)
    print("pd library", cs.time_ms(lambda: cs.library_decode(*args), flush))
    # the CUDA-core kernel for comparison (f32 q, bf16 pool)
    args32 = (args[0].float(),) + args[1:]
    print("pd cuda-core f32 q ns=4", cs.time_ms(lambda: pdk.paged_decode_cuda(*args32, n_splits=4), flush))

    gen = torch.Generator(device="cuda").manual_seed(3)
    B, S, H, P, N = 1, 2048, 48, 64, 128
    xh = torch.randn(B, S, H, P, generator=gen, device="cuda")
    a = -torch.randn(B, S, H, generator=gen, device="cuda").abs() * 0.1
    Bm = torch.randn(B, S, N, generator=gen, device="cuda")
    Cm = torch.randn(B, S, N, generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        x_, B_, C_ = (t.to(dtype) for t in (xh, Bm, Cm))
        for ch in (16, 32, 64, 128):
            got = ssk.ssd_chunk_cuda(x_, a, B_, C_, chunk=ch)
            want = ssd_chunk_ref(x_, a, B_, C_, chunk=ch)
            torch.cuda.synchronize()
            errs = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
            tol = 1e-3 if dtype == torch.float32 else 5e-1
            print(f"ssd {dtype} chunk={ch}: errs {['%.2e' % e for e in errs]} |y| {float(want[0].float().abs().max()):.1f}", flush=True)
            if not max(errs[1:] + [errs[0] if dtype == torch.float32 else 0]) <= tol:
                failures.append(("ssd", str(dtype), ch, errs))
    for ch in (32, 64, 128):
        print(f"ssd timing chunk={ch}: {cs.time_ms(lambda: ssk.ssd_chunk_cuda(xh, a, Bm, Cm, chunk=ch), flush, 20, 3):.4f} ms", flush=True)
    print("FAILURES", failures)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
