#!/usr/bin/env python3
"""Numerics and speed of variants of the 3xTF32 paged decode kernel (every
type pair but bf16 q and pools at rep <= 8), on one card.

    python3 scripts/paged_decode_f32_variants.py [--reps 30]

Builds variants of ``src/repro_torch/kernels/paged_decode/csrc/
paged_decode.cu`` by editing its text (into ``build/paged_decode_f32_variants/``),
each a library with the kernel's own C interface:

* the kernel as it stands (a tile's 8-token groups dealt to up to 8
  warps);
* 4 warps a block at tiles of 64 tokens and more (TK / 16 below), each
  with two 8-token groups of a 64-token tile, as the bf16 kernel deals its
  tiles;
* rings of 2 and 4 stages (the kernel: 3; 4 stages of 64 f32 tokens do
  not fit at Dh 128);
* the same ring with the products on the CUDA cores: each lane forms its
  partial dots over the dims its fragments hold, for the 8 tokens of a
  group, by scalar FMAs from shared memory, reduced over the 4 lanes of a
  row, and P·V from the row's 8 weights gathered by shuffles.

For each it prints ptxas's registers and spills and the SASS HMMA count of
every tf32 instantiation, then holds it against the plain version at the
cache_len edges of ``chip_smoke.py`` (f32 q and pools at Dh 128 and 64, f32
q over a bf16 pool, bf16 q over an f32 pool, rep 1, 4, 5, 8, every tile
that fits, splits 1 and 8), gated at ``chip_smoke.TOL``.  Then it times
the variants in turns (CUDA events, L2 flushed by a 256 MB write as
``chip_smoke.time_ms`` does; the order, reversed, and again) at the
serving shape (B 8, H 32 / Hkv 8, Dh 128, bs 256, NB 8, ``chip_smoke.py``'s
ragged fills) for f32 q and pools and for f32 q over a bf16 pool, at each
tile and split, beside gather + SDPA in f32 and the bytes bound; each
variant's best config and a ``torch.sum`` over the same bytes also under a
read flush (the write leaves up to 50 MB of dirty lines in L2, which the
kernel's reads then write back).  Prints FAILURES [] when every check
holds.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "paged_decode" / "csrc" / "paged_decode.cu"
OUT = ROOT / "build" / "paged_decode_f32_variants"


W0 = "    const int w0 = max(1, min(TK / 8, kPassWarps / min(n_groups, kPassWarps)));"
FOUR_WARPS = [(W0, W0.replace("TK / 8,", "TK >= 64 ? 4 : TK / 16,"))]
STAGES = "constexpr int kStages = 3;          // ring stages of K and V tiles"
SCALAR_SCORES = """
  const int t = lane & 3;
  float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < DH / 8; ++ks)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const float qv = __uint_as_float(qa[ks][2 * jj]) + __uint_as_float(qa[ks][2 * jj + 1]);
      const int d = k_dim<KT>(ks, t + 4 * jj);
#pragma unroll
      for (int u = 0; u < 8; ++u) part[u] = fmaf(qv, kv_elt<KT, DH>(kt, tok0 + u, d), part[u]);
    }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    part[u] += __shfl_xor_sync(0xffffffffu, part[u], 1);
    part[u] += __shfl_xor_sync(0xffffffffu, part[u], 2);
    if (u == 2 * t) s[0][0] += part[u];
    if (u == 2 * t + 1) s[0][1] += part[u];
  }
"""
SCALAR_PV = """
  const int g = lane >> 2, t = lane & 3;
  float p[8];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    p[2 * u] = __shfl_sync(0xffffffffu, p0, 4 * g + u);
    p[2 * u + 1] = __shfl_sync(0xffffffffu, p1, 4 * g + u);
  }
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float acc = o[n][e];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = fmaf(p[u], kv_elt<KT, DH>(vt, tok0 + u, 8 * n + 2 * t + e), acc);
      o[n][e] = acc;
    }
"""
KV_ELT = """template <typename KT, int DH>
__device__ __forceinline__ float kv_elt(const KT* tile, int tok, int d) {
  constexpr int EPC = 16 / sizeof(KT);
  return to_f32(tile[tok * DH + ((d / EPC) ^ (tok & 7)) * EPC + d % EPC]);
}

"""
TWO_STAGES = [(STAGES, STAGES.replace("3;", "2;"))]
VARIANTS = {"as it stands": [], "4 warps": FOUR_WARPS, "2 stages": TWO_STAGES,
            "4 stages": [(STAGES, STAGES.replace("3;", "4;"))],
            "CUDA-core products": "scalar"}
PAIRS = {"f32/f32": ("float32", "float32"), "f32 q/bf16 pool": ("float32", "bfloat16"),
         "bf16 q/f32 pool": ("bfloat16", "float32")}


def _body(text: str, signature: str, body: str) -> str:
    """``text`` with the body of the function whose signature starts at
    ``signature`` replaced by ``body``."""
    start = text.index("{", text.index(signature))
    depth = 0
    for end in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[end], 0)
        if depth == 0:
            break
    return text[:start] + "{" + body + "}" + text[end + 1:]


def source_of(edits) -> str:
    text = SOURCE.read_text()
    if edits == "scalar":
        text = _body(text, "__device__ __forceinline__ void group_scores(", SCALAR_SCORES)
        text = _body(text, "__device__ __forceinline__ void group_pv(", SCALAR_PV)
        at = text.index("// Scores of one group of 8 tokens")
        return text[:at] + KV_ELT + text[at:]
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"the source no longer has {old!r}")
        text = text.replace(old, new)
    return text


def build(name: str, edits):
    from chip_smoke import ptxas_kernels, sass_mma_count
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    from repro_torch.kernels.paged_decode.kernel import PagedDecodeKernel

    stem = name.replace(" ", "_").replace("/", "_")
    cu, so = OUT / f"{stem}.cu", OUT / f"{stem}.so"
    cu.write_text(source_of(edits))
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    sass = sass_mma_count(str(so), by_function=True) or {}
    print(f"build {name}: " + "; ".join(
        f"{k} {r} registers, {s} B spilled, HMMA {sass.get(k, {}).get('HMMA', '?')}"
        for k, r, s in ptxas_kernels(proc.stdout + proc.stderr) if "tf32" in k), flush=True)
    kernel = PagedDecodeKernel(name=f"variant_{stem}", sources=[cu])
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_decode_launch.argtypes = [vp] * 9 + [i] * 8 + [ctypes.c_float, i, i, vp]
    lib.paged_decode_launch.restype = i
    lib.paged_decode_smem_bytes.argtypes = [i] * 3
    lib.paged_decode_smem_bytes.restype = ctypes.c_longlong
    kernel._lib = lib
    return kernel


def read_flush_ms(fn, flush, reps: int) -> float:
    """Median ms of ``fn`` by CUDA events, a 256 MB read of ``flush``
    before each call in place of ``chip_smoke.time_ms``'s write (and the
    same spin after it)."""
    import statistics

    import torch

    from repro_torch.bench.kernel_bench import SPIN_CYCLES

    for _ in range(5):
        fn()
    events = []
    for _ in range(reps):
        flush.max()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.autotune import SMEM_BYTES_PER_BLOCK
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref

    if not torch.cuda.is_available():
        print("paged_decode_f32_variants: CUDA is not available", file=sys.stderr)
        return 1
    print(f"device {cs.card_line()}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        kernels = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))

    def tiles(kernel, Dh, kv):
        """The tiles whose ring fits, in this build (its own stages)."""
        return [b for b in (16, 32, 64, 128, 256)
                if kernel.load().paged_decode_smem_bytes(Dh, b, int(kv == "bfloat16"))
                <= SMEM_BYTES_PER_BLOCK]

    def case(pair, Dh, cache_lens, seed=0, H=None, Hkv=None):
        q_dt, kv_dt = (getattr(torch, d) for d in PAIRS[pair])
        q, kp, vp, bt, cl = cs.decode_case(kv_dt, Dh, cache_lens, seed=seed, H=H, Hkv=Hkv)
        return q.to(q_dt), kp, vp, bt, cl

    failures = []
    bs, NB = cs.DECODE["bs"], cs.DECODE["NB"]
    edges = [0, bs - 1, bs, 2 * bs - 1, 3 * bs, 5 * bs + 17, NB * bs - 1, 700]
    for pair in PAIRS:
        for Dh in (128, 64):
            for H, Hkv in ((32, 32), (32, 8), (40, 8), (32, 4)):
                a = case(pair, Dh, edges, H=H, Hkv=Hkv)
                want = paged_decode_ref(*a).float()
                tol = cs.TOL[PAIRS[pair][0]]
                errs = {}
                for name, kern in kernels.items():
                    err = 0.0
                    for bkv in tiles(kern, Dh, PAIRS[pair][1]):
                        for ns in (1, 8):
                            got = kern(*a, block_kv=bkv, n_splits=ns).float()
                            torch.cuda.synchronize()
                            e = float((got - want).abs().max()) if torch.isfinite(got).all() \
                                else float("inf")
                            err = max(err, e)
                    errs[name] = err
                    if not err <= tol:
                        failures.append((name, pair, Dh, H, Hkv, err))
                print(f"check {pair} Dh={Dh} rep={H // Hkv}: " + "; ".join(
                    f"{n} {e:.3e}" for n, e in errs.items()), flush=True)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    fills = (np.random.default_rng(1).integers(64, 1537, cs.DECODE["B"]) + 16).tolist()
    for pair in ("f32/f32", "f32 q/bf16 pool"):
        a = case(pair, cs.DECODE["Dh"], fills, seed=1)
        f32 = tuple(x.float() if x.is_floating_point() else x for x in a)
        bound_ms, bound_by = cs.bound(a[0], a[1], a[4])
        library = cs.time_ms(lambda: cs.library_decode(*f32), flush, args.reps)
        plain = cs.time_ms(lambda: paged_decode_ref(*a), flush, args.reps)
        configs = {n: [(bkv, ns) for bkv in tiles(kernels[n], cs.DECODE["Dh"], PAIRS[pair][1])
                       if bkv <= 128 for ns in (1, 2, 4, 8)] for n in VARIANTS}
        times = {(n, c): [] for n in VARIANTS for c in configs[n]}
        for order in (list(VARIANTS), list(VARIANTS)[::-1], list(VARIANTS)):
            for name in order:
                for bkv, ns in configs[name]:
                    times[name, (bkv, ns)].append(cs.time_ms(
                        lambda: kernels[name](*a, block_kv=bkv, n_splits=ns), flush, args.reps))
        # the same bytes read by one library call, and each variant's best
        # config, under the write flush and under a read flush (no dirty
        # lines left in L2 for the reads to write back)
        live = int((a[4].long() + 1).sum())
        same = torch.zeros(2 * live * cs.DECODE["Hkv"] * cs.DECODE["Dh"], dtype=a[1].dtype,
                           device="cuda")
        reread = read_flush_ms(same.sum, flush, args.reps)
        print(f"timing {pair} B=8 H=32 Hkv=8 Dh=128 bs=256 NB=8 live_tokens={live}: bound "
              f"{bound_ms:.4f} ms ({bound_by}), gather+sdpa f32 {library:.4f} ms, plain "
              f"{plain:.4f} ms; torch.sum over the same {same.numel() * same.element_size() / 1e6:.1f} "
              f"MB {cs.time_ms(same.sum, flush, args.reps):.4f} ms (write flush), "
              f"{reread:.4f} ms (read flush)", flush=True)
        for name in VARIANTS:
            best = min(configs[name], key=lambda c: min(times[name, c]))
            read = read_flush_ms(lambda: kernels[name](*a, block_kv=best[0], n_splits=best[1]),
                                 flush, args.reps)
            print(f"timing {pair} {name}: " + "; ".join(
                f"{bkv}/{ns} " + " / ".join(f"{x:.4f}" for x in times[name, (bkv, ns)])
                for bkv, ns in configs[name])
                + f" -> best {best[0]}/{best[1]} {min(times[name, best]):.4f} ms, "
                f"{bound_ms / min(times[name, best]):.1%} of bound; read flush {read:.4f} ms "
                f"({bound_ms / read:.1%})", flush=True)
    print(f"FAILURES {failures}")
    print(f"device {cs.card_line()}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
