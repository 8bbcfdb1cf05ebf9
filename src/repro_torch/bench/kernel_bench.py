"""Kernel micro-benchmarks (port of ``benchmarks/kernel_bench.py``).

Three kinds of row, the reference's CSV names through ``common.csv_line``:

* **model rows** (``model_default_us``, ``model_tuned_us``,
  ``model_gather_us``, the ``serve_kv`` joint block and the tuner's
  second-pass hits) — the autotuner's pick against the hand-coded default
  under the same roofline model, for the reference's ``tpu_v5e`` spec
  with ``measure=False``.  Framework-free: they equal the reference's.
* **``ref_us`` rows** — the plain PyTorch version timed at the reference's
  shape on the run's device (CUDA events on the card, ``perf_counter`` on
  the CPU), beside ``roofline_us``: the least time for its bytes and
  FLOPs on the spec of the device the row ran on
  (``engine.devices.from_torch_device``), named in the row.  The
  reference reads a TPU's constants there; the port does not copy them.
* **``card_us`` rows, on the card only** — each Hopper kernel at the
  bench's shapes and its tiling's default config, then at the config a
  tuner for this card's spec ranks first without timing where that
  differs: its time (CUDA events, L2 flushed, median of 30 after 5), its
  launches, its error against the plain version on the same inputs
  (raising outside the stated tolerance), the card's bound for the work
  and the kernel's share of it.

    PYTHONPATH=src python -m repro_torch.bench.kernel_bench [--device cpu]

The tuning cache is ``build/repro_torch/kernel_bench_tuning.json``, made
afresh by every run.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

import numpy as np
import torch

from repro_torch.bench.common import csv_line
from repro_torch.device import resolve_device
from repro_torch.engine.devices import from_torch_device, get_device
from repro_torch.kernels.autotune import KernelTuner, roofline_seconds
from repro_torch.kernels.build import BUILD_DIR
from repro_torch.kernels.conv_mm import tiling as conv_tiling
from repro_torch.kernels.conv_mm.ref import conv_ref
from repro_torch.kernels.flash_attention import tiling as flash_tiling
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.moe_dispatch import tiling as moe_tiling
from repro_torch.kernels.paged_decode import tiling as pd_tiling
from repro_torch.kernels.serve_kv import tiling as kv_tiling
from repro_torch.kernels.ssm_scan import tiling as ssm_tiling
from repro_torch.kernels.ssm_scan.ref import ssd_ref

__all__ = ["TUNING_CACHE", "CARD_TOL", "run", "card_rows", "card_time_ms"]

TUNING_CACHE = str(BUILD_DIR / "kernel_bench_tuning.json")

# the card's f32 rate outside the tensor cores (NVIDIA H100 SXM data sheet,
# dense, at the 700 W limit); bf16 takes the spec's peak_flops (989 TFLOP/s)
F32_FLOPS = 67e12

# each card row's kernel against its plain version on the same inputs:
# bf16 outputs may round to either neighbour of the same f32 value (one ulp
# at |o| < 2 is <= 2^-7); f32 SSD sums of up to chunk·N products in another
# order; conv: (rtol, atol) on outputs of unit variance
CARD_TOL = {"flash_attention": 1e-2, "conv_mm": (8e-3, 1e-2), "ssd_chunk": 1e-3,
            "paged_decode": 1e-2}

# the bench's shapes (the reference's)
FLASH = dict(B=1, H=8, S=2048, Dh=128)
CONV = dict(N=8, HW=32, C=128, K=3, O=128)
SSD = dict(B=1, S=2048, H=24, P=64, N=128, chunk=128)
DECODE = dict(B=8, H=32, Hkv=8, Dh=128, NB=16, bs=256)


def _time_us(fn, dev: torch.device, n: int = 3) -> float:
    """Median of ``n`` calls after one warm call, in µs: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        events = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return float(statistics.median(s.elapsed_time(e) for s, e in events)) * 1e3
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e6


def _fmt(config: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(config.items()))


def _tuned_rows(tuner: KernelTuner, kernel: str, shape: dict, print_fn) -> dict:
    """Emit model_default_us / model_tuned_us rows for one kernel shape."""
    entry = tuner.explain(kernel, shape)
    default_us = entry["default_model_us"]
    tuned_us = entry["model_us"]   # modelled time of the chosen config
    speedup = default_us / max(tuned_us, 1e-12)
    print_fn(csv_line(f"kernel/{kernel}/model_default_us", default_us,
                      _fmt(entry["default_config"])))
    print_fn(csv_line(f"kernel/{kernel}/model_tuned_us", tuned_us,
                      f"{_fmt(entry['config'])} speedup={speedup:.2f}x "
                      f"vmem_kb={entry['vmem_kb']:.0f} "
                      f"cands={entry['candidates']} "
                      f"rejected_vmem={entry['rejected_vmem']} "
                      f"source={entry['source']}"))
    return {"default_us": default_us, "tuned_us": tuned_us,
            "speedup": speedup, "config": entry["config"]}


def _roofline(flops: float, bytes_: float, spec) -> str:
    return (f"AI={flops / bytes_:.0f} roofline_us="
            f"{max(flops / spec.peak_flops, bytes_ / spec.hbm_bw) * 1e6:.1f} "
            f"({spec.name})")


def run(print_fn=print, *, device="cuda") -> dict:
    """Model rows under ``tpu_v5e``, ``ref_us`` rows on ``device`` and, on
    the card, :func:`card_rows`."""
    dev = resolve_device(device)
    spec = from_torch_device(dev)
    if os.path.exists(TUNING_CACHE):
        os.unlink(TUNING_CACHE)
    tuner = KernelTuner(device=get_device("tpu_v5e"), cache=TUNING_CACHE,
                        measure=False)
    results: dict = {}
    rng = np.random.default_rng(0)

    def tensor(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype).to(dev)

    # flash attention: (B,H,S,Dh) production-ish tile
    B, H, S, Dh, bq, bk = 1, 8, 2048, 128, 512, 512
    flops = 4.0 * B * H * S * S * Dh * 0.5  # causal
    bytes_ = 2.0 * (B * H * S * Dh * 3 + B * H * S * Dh)
    vmem = (bq * Dh + 2 * bk * Dh) * 2 + bq * Dh * 4
    q = tensor((B, H, S, Dh), torch.bfloat16)
    us = _time_us(lambda: attention_ref(q, q, q, causal=True), dev)
    print_fn(csv_line("kernel/flash_attn/ref_us", us,
                      f"{_roofline(flops, bytes_, spec)} vmem_kb={vmem / 1024:.0f}"))
    results["flash_attention"] = _tuned_rows(
        tuner, "flash_attention",
        flash_tiling.shape_key((B, H, S, Dh), (B, H, S, Dh), causal=True,
                               dtype="bfloat16"),
        print_fn)

    # conv_mm: ResNet-ish layer
    N, HW, C, K, O = 8, 32, 128, 3, 128
    flops = 2.0 * N * HW * HW * O * K * K * C
    bytes_ = 2.0 * (N * HW * HW * C + K * K * C * O + N * HW * HW * O)
    x = tensor((N, HW, HW, C), torch.bfloat16)
    w = tensor((K, K, C, O), torch.bfloat16)
    us = _time_us(lambda: conv_ref(x, w, stride=1, padding=1), dev)
    print_fn(csv_line("kernel/conv_mm/ref_us", us, _roofline(flops, bytes_, spec)))
    results["conv_mm"] = _tuned_rows(
        tuner, "conv_mm",
        conv_tiling.shape_key((N, HW, HW, C), (K, K, C, O), stride=1,
                              padding=1, dtype="bfloat16"),
        print_fn)

    # ssd: mamba2-780m layer tile
    B2, S2, Hh, P, Nst, ch = 1, 2048, 24, 64, 128, 128
    flops = 2.0 * B2 * S2 * ch * Hh * (Nst + P) + 2.0 * B2 * S2 * Hh * P * Nst
    bytes_ = 2.0 * B2 * S2 * Hh * P * 2 + 4.0 * B2 * S2 * Hh
    xh = tensor((B2, S2, Hh, P), torch.float32)
    a = -tensor((B2, S2, Hh), torch.float32).abs() * 0.1
    Bm = tensor((B2, S2, Nst), torch.float32)
    us = _time_us(lambda: ssd_ref(xh, a, Bm, Bm, chunk=ch)[0], dev)
    print_fn(csv_line("kernel/ssd/ref_us", us, _roofline(flops, bytes_, spec)))
    results["ssm_scan"] = _tuned_rows(
        tuner, "ssm_scan",
        ssm_tiling.shape_key((B2, S2, Hh, P), Nst, dtype="float32"),
        print_fn)

    # moe dispatch: qwen3-moe-30b-ish layer (model rows only: no kernel in
    # either package, so no standalone plain version to time)
    Bm_, Sm_, Dm_, Em_, Km_, Fm_ = 8, 2048, 2048, 128, 8, 768
    moe_shape = moe_tiling.shape_key(Bm_, Sm_, Dm_, Em_, Km_, Fm_, 1.25,
                                     "bfloat16")
    results["moe_dispatch"] = _tuned_rows(tuner, "moe_dispatch", moe_shape,
                                          print_fn)

    # paged decode: the serving hot path — 8 slots, long KV, GQA, paged
    # pool; the gather baseline is the dense fallback at the same shape,
    # priced by the same roofline (it streams the whole logical view)
    Bp, Hp, Hkvp, Dhp, NBp, bsp = 8, 32, 8, 128, 16, 256
    pd_shape = pd_tiling.shape_key(Bp, Hp, Hkvp, Dhp, NBp, bsp, "bfloat16")
    results["paged_decode"] = _tuned_rows(tuner, "paged_decode", pd_shape,
                                          print_fn)
    gather_us = roofline_seconds(pd_tiling.gather_cost(pd_shape),
                                 get_device("tpu_v5e")) * 1e6
    results["paged_decode"]["gather_us"] = gather_us
    results["paged_decode"]["vs_gather"] = (
        gather_us / max(results["paged_decode"]["tuned_us"], 1e-12))
    print_fn(csv_line("kernel/paged_decode/model_gather_us", gather_us,
                      f"vs_tuned={results['paged_decode']['vs_gather']:.2f}x "
                      f"(full {NBp * bsp}-token logical view, no early exit)"))

    # serve_kv ⇄ paged_decode joint resolution: the pool block size the
    # serve_kv model picks must admit the kernel's tuned block_kv
    kv_shape = kv_tiling.shape_key(Bp, NBp * bsp, Hkvp, Dhp, "bfloat16",
                                   n_heads=Hp)
    kv_bs = int(tuner.tune("serve_kv", kv_shape)["block_size"])
    pd_joint_shape = pd_tiling.shape_key(
        Bp, Hp, Hkvp, Dhp, -(-NBp * bsp // kv_bs), kv_bs, "bfloat16")
    kv_bkv = int(tuner.tune("paged_decode", pd_joint_shape)["block_kv"])
    results["serve_kv_joint"] = {
        "block_size": kv_bs, "block_kv": kv_bkv,
        "aligned": kv_bs % kv_bkv == 0,
    }
    print_fn(csv_line("kernel/serve_kv/joint_block_size", kv_bs,
                      f"paged_decode_block_kv={kv_bkv} "
                      f"aligned={kv_bs % kv_bkv == 0}"))

    # second visit to the whole grid must be pure cache hits (no re-search)
    h0, m0 = tuner.hits, tuner.misses
    for kernel, shape in (
        ("flash_attention", flash_tiling.shape_key(
            (B, H, S, Dh), (B, H, S, Dh), causal=True, dtype="bfloat16")),
        ("conv_mm", conv_tiling.shape_key(
            (N, HW, HW, C), (K, K, C, O), stride=1, padding=1,
            dtype="bfloat16")),
        ("ssm_scan", ssm_tiling.shape_key(
            (B2, S2, Hh, P), Nst, dtype="float32")),
        ("moe_dispatch", moe_shape),
        ("paged_decode", pd_shape),
        ("serve_kv", kv_shape),
    ):
        tuner.tune(kernel, shape)
    results["second_call_hits"] = tuner.hits - h0
    results["second_call_misses"] = tuner.misses - m0
    print_fn(csv_line("kernel/autotune/second_call_hits",
                      results["second_call_hits"],
                      f"misses={results['second_call_misses']} expect=6/0"))
    if dev.type == "cuda":
        results["card"] = card_rows(print_fn, dev)
    return results


# ---------------------------------------------------------------------------
# the Hopper kernels on the card
# ---------------------------------------------------------------------------


def card_time_ms(fn, flush, reps: int = 30, warmup: int = 5) -> float:
    """Median time of one call in ms by CUDA events, with L2 flushed (a
    256 MB write into ``flush``) before every call.  ``chip_smoke.py``
    times its kernels with it too."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _card_row(print_fn, name, wrapper, kernel_fn, plain_fn, err_fn, flops, nbytes,
              peak, hbm_bw, flush, configs) -> dict:
    """Time one kernel at each config of ``configs`` (its launches counted
    around the timing), hold each against the plain version and print
    ``kernel/<name>/card_us`` at the first (the tiling's default); the
    others go in the derived text."""
    wrapper.launches = 0
    want = plain_fn()
    timed = []
    for label, cfg in configs:
        ms = card_time_ms(lambda: kernel_fn(cfg), flush)
        got = kernel_fn(cfg)
        torch.cuda.synchronize()
        err, ok = err_fn(got, want)
        timed.append((label, cfg, ms, err, ok))
    launches = wrapper.launches - len(configs)      # the checks' own calls apart
    plain_ms = card_time_ms(plain_fn, flush, reps=5, warmup=1)
    t_ops, t_bytes = flops / peak, nbytes / hbm_bw
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    _, cfg, ms, err, _ = timed[0]
    others = " ".join(f"{label}_us={t * 1e3:.2f} at {_fmt(c)} (share {bound_ms / t:.1%}, "
                      f"max_abs_err {e:.3e})" for label, c, t, e, _ in timed[1:])
    print_fn(csv_line(f"kernel/{name}/card_us", ms * 1e3,
                      f"launches={launches} max_abs_err={err:.3e} "
                      f"tol={CARD_TOL[name]} bound_us={bound_ms * 1e3:.2f} "
                      f"bound_by={bound_by} share={bound_ms / ms:.1%} "
                      f"plain_us={plain_ms * 1e3:.1f} default {_fmt(cfg)} {others}".rstrip()))
    bad = [(label, e) for label, _, _, e, ok in timed if not ok]
    if bad:
        raise AssertionError(f"{name} disagrees with its plain version at the "
                             f"bench's shape: {bad}")
    return {"us": ms * 1e3, "launches": launches, "configs": len(configs),
            "max_abs_err": max(t[3] for t in timed), "bound_us": bound_ms * 1e3,
            "bound_by": bound_by, "share": bound_ms / ms, "plain_us": plain_ms * 1e3,
            "timed": {label: (c, t * 1e3) for label, c, t, _, _ in timed}}


def _configs(tiling, tuner, kernel, shape) -> list:
    """The tiling's default config, then the card tuner's untimed pick
    when it differs."""
    default, tuned = tiling.default(shape), tuner.tune(kernel, shape)
    return [("default", default)] + ([("tuned", tuned)] if tuned != default else [])


def card_rows(print_fn=print, device="cuda") -> dict:
    """``kernel/<name>/card_us`` for the four Hopper kernels at the bench's
    shapes, on the card: flash attention bf16 (1, 8, 2048, 128) causal,
    ``conv_mm`` bf16 (8, 32, 32, 128) × (3, 3, 128, 128), the SSD
    intra-chunk pass f32 (1, 2048, 24, 64) N 128 chunk 128, and paged
    decode bf16 B 8, H 32, Hkv 8, Dh 128 over 16 blocks of 256 at full
    ``cache_len``.  Each at its tiling's default config (the row's value),
    then at the config a tuner for this card ranks first without timing,
    where that differs (in the derived text)."""
    from repro_torch.kernels.conv_mm.kernel import conv_mm_cuda
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.paged_decode.kernel import paged_decode_cuda
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref
    from repro_torch.kernels.ssm_scan.kernel import ssd_chunk_cuda
    from repro_torch.kernels.ssm_scan.ref import ssd_chunk_ref

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("card_rows times the CUDA kernels: pass a CUDA device")
    spec = from_torch_device(dev)
    card_tuner = KernelTuner(device=spec, measure=False)
    bf16, f32 = spec.peak_flops, F32_FLOPS
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def max_err(tol):
        def err(got, want):
            e = float((got.float() - want.float()).abs().max())
            return e, bool(torch.isfinite(got).all()) and e <= tol
        return err

    out = {}
    B, H, S, Dh = (FLASH[k] for k in ("B", "H", "S", "Dh"))
    q, k, v = (randn(B, H, S, Dh, dtype=torch.bfloat16) for _ in range(3))
    out["flash_attention"] = _card_row(
        print_fn, "flash_attention", flash_attention_cuda,
        lambda cfg: flash_attention_cuda(q, k, v, causal=True, **cfg),
        lambda: attention_ref(q, k, v, causal=True),
        max_err(CARD_TOL["flash_attention"]),
        4.0 * B * H * S * S * Dh * 0.5, 2.0 * 4 * B * H * S * Dh, bf16, spec.hbm_bw,
        flush, _configs(flash_tiling, card_tuner, "flash_attention", flash_tiling.shape_key(
            q.shape, k.shape, causal=True, dtype="bfloat16")))

    N, HW, C, K, O = (CONV[k] for k in ("N", "HW", "C", "K", "O"))
    x = randn(N, HW, HW, C, dtype=torch.bfloat16)
    w = randn(K, K, C, O, dtype=torch.bfloat16, scale=(K * K * C) ** -0.5)
    rtol, atol = CARD_TOL["conv_mm"]

    def conv_err(got, want):
        diff = (got.float() - want.float()).abs()
        ok = bool((diff <= atol + rtol * want.float().abs()).all())
        return float(diff.max()), ok and bool(torch.isfinite(got).all())

    out["conv_mm"] = _card_row(
        print_fn, "conv_mm", conv_mm_cuda,
        lambda cfg: conv_mm_cuda(x, w, stride=1, padding=1, **cfg),
        lambda: conv_ref(x, w, stride=1, padding=1), conv_err,
        2.0 * N * HW * HW * O * K * K * C,
        2.0 * (N * HW * HW * C + K * K * C * O + N * HW * HW * O), bf16, spec.hbm_bw,
        flush, _configs(conv_tiling, card_tuner, "conv_mm", conv_tiling.shape_key(
            x.shape, w.shape, stride=1, padding=1, dtype="bfloat16")))

    B, S, H, P, Nst, ch = (SSD[k] for k in ("B", "S", "H", "P", "N", "chunk"))
    xh = randn(B, S, H, P)
    a = -randn(B, S, H).abs() * 0.1
    Bm, Cm = randn(B, S, Nst), randn(B, S, Nst)

    def ssd_err(got, want):
        e = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, want))
        ok = all(bool(torch.isfinite(g).all()) for g in got)
        return e, ok and e <= CARD_TOL["ssd_chunk"]

    # least work: C·Bᵀ once per chunk (one group), then per head the lower
    # triangle of (s∘L)·x and the (N, P) state; the chunk is the bench's
    nc, tri = S // ch, ch * (ch + 1) / 2
    out["ssd_chunk"] = _card_row(
        print_fn, "ssd_chunk", ssd_chunk_cuda,
        lambda cfg: ssd_chunk_cuda(xh, a, Bm, Cm, **cfg),
        lambda: ssd_chunk_ref(xh, a, Bm, Cm, chunk=ch), ssd_err,
        2 * B * nc * (tri * Nst + H * (tri * P + ch * Nst * P)),
        4 * (2 * B * S * H * P + 2 * B * S * Nst + 2 * B * S * H
             + B * nc * H * (Nst * P + 1)), f32, spec.hbm_bw, flush,
        [("default", {"chunk": ch})])

    B, H, Hkv, Dh, NB, bs = (DECODE[k] for k in ("B", "H", "Hkv", "Dh", "NB", "bs"))
    qd = randn(B, H, Dh, dtype=torch.bfloat16)
    kp, vp = (randn(B * NB + 1, bs, Hkv, Dh, dtype=torch.bfloat16) for _ in range(2))
    bt = (torch.randperm(B * NB, generator=gen, device=dev) + 1).view(B, NB).to(torch.int32)
    cl = torch.full((B,), NB * bs - 1, dtype=torch.int32, device=dev)
    live = B * NB * bs
    out["paged_decode"] = _card_row(
        print_fn, "paged_decode", paged_decode_cuda,
        lambda cfg: paged_decode_cuda(qd, kp, vp, bt, cl, **cfg),
        lambda: paged_decode_ref(qd, kp, vp, bt, cl),
        max_err(CARD_TOL["paged_decode"]),
        4.0 * H * Dh * live,
        2.0 * (2 * Hkv * Dh * live + 2 * B * H * Dh) + 4.0 * (B * NB + B),
        bf16, spec.hbm_bw, flush, _configs(pd_tiling, card_tuner, "paged_decode",
                                           pd_tiling.shape_key(B, H, Hkv, Dh, NB, bs,
                                                               "bfloat16")))
    del flush
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args().device)
