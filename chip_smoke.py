#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build — compile every CUDA kernel from the sources in this checkout,
   one ``nvcc`` per kernel, all started together (→ ``build/repro_torch/``);
   print ``-Xptxas -v`` (registers, spills) for each kernel instantiation
   and the count of tensor-core instructions (HGMMA, HMMA) in the SASS
   (``cuobjdump -sass``) of the paged decode, flash attention and SSD
   libraries, none of which may be 0; hold the shared memory the tiling
   models report against the sources' own formulas, all four kernels;
3. tune — the kernel autotuner on the card: a ``KernelTuner`` for this
   card (``from_torch_device``, ``measure=True``) on a fresh cache
   installed as the process default; ``warm_autotune`` for full-width
   qwen3-4b (batch 8, 2048 tokens, prefill and decode) times the flash
   attention kernel through its tiling runner, ``tune("ssm_scan")`` times
   the SSD kernel at mamba2-780m's shape, and paged decode is tuned at
   every table width the served decode step uses; every ``explain()``
   entry is printed, and each kernel's launches during the phase must
   equal four per timed config (one warm call, three timed);
4. kernels — hold each kernel against its plain PyTorch version on the
   card: paged decode at qwen3-4b decode shapes (bf16 at head dims 64 and
   128, rep 1, 4, 5 and 8, every token tile that fits and 1, 2, 4 and 8
   splits, each at the cache_len edges; f32), the MM convolution on
   every convolution shape of full-width ResNet-50 and on edge cases,
   flash attention at the qwen3-4b prefill shape and edge cases (fully
   masked rows against mean(V), also over a ragged last tile), the SSD
   intra-chunk pass at the mamba2-780m shape for every chunk the tuner may
   return, in f32 and with bf16 inputs; time kernel, plain version, a
   library yardstick and the bound with CUDA events (paged decode also at
   each token tile and split);
5. serve — full-width qwen3-4b (random weights from seed 0, bf16) served
   by ``ContinuousEngine`` over the paged KV pool: 16 greedy requests,
   with the paged-decode launch count read around the run; then the
   kernel is held against its plain version on the served model's own
   inputs, and a reduced qwen3-4b on the card is held against the same
   model on the CPU (the port's plain path); launches the tuner makes
   inside this window (a prefill shape it has not seen) are counted
   apart and printed;
6. cnn — the paper's toolflow: one training step of a reduced ResNet-50
   on the card against the CPU; then full-width ResNet-50 (32x32,
   CIFAR-100) pruned, profiled for Γ and Φ over the paper's train levels
   and the default test levels at five batch sizes (``collect_grid``),
   with the convolution kernel's launch count read around the grid, then
   the kernel held against its plain version at every (batch size,
   convolution shape) the grid gave it; the predictor fitted on the
   train points and its Γ/Φ error printed for each test grid; and a
   traced step at batch 128 (where the time goes);
7. engine — paper §6.4 through the cost engine: an analytical spec of
   this card calibrated on the cnn phase's train grid (every workload
   from the cnn phase's cache, none profiled) and the tuner's timed
   winners; 16 full-width ResNet-50 sub-networks (seeds 2000 + i)
   profiled for inference at bs 1, 2, 4, 8 and for training at bs 16,
   the inference forest fitted on 10 and tested on 6; the evolutionary
   search (population 32, 40 iterations) through a ``CostEngine`` over
   forest → calibrated analytical → profiler, under no budget and under
   budgets at the median and the lower quartile of the sub-networks'
   measurements; each winner measured by the engine's chain; tier A
   repeated (same result, no new miss); the convolution kernel's launch
   count read around the phase;
8. a ``{"kernels": [...]}`` JSON line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Without CUDA, or without the rest of the repository beside it, it fails
before printing any result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

TF32_FLOPS = 495e12          # tensor cores, a ceiling for a later conv design

# qwen3-4b decode at the serving configuration below
DECODE = dict(B=8, H=32, Hkv=8, Dh=128, bs=256, NB=8)
TOL = {"float32": 2e-5, "bfloat16": 1e-2}
REPLACES = "src/repro/kernels/paged_decode/kernel.py:120"
CONV_REPLACES = "src/repro/kernels/conv_mm/kernel.py:57"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:66"
SSD_REPLACES = "src/repro/kernels/ssm_scan/kernel.py:57"
# flash attention against its plain version: bf16 outputs may round to
# either neighbour of the same f32 value (one ulp at |o| < 2 is <= 2^-7);
# f32 sums in another order stay far inside 1e-4
FLASH_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# SSD intra-chunk pass and the whole op, f32 at mamba2-780m's shape: |y| is
# O(10) and sums run over up to l·N products in another order
SSD_TOL = 1e-3
# the tune phase's shapes: full-width qwen3-4b at batch 8 over 2048 tokens,
# and mamba2-780m's SSD layer (d_inner 3072 / head_dim 64 = 48 heads,
# ssm_state 128) at 2048 tokens
TUNE_BATCH, TUNE_SEQ = 8, 2048
SSD_SHAPE = dict(B=1, S=2048, H=48, P=64, N=128)
# conv_mm against its plain version: outputs of unit variance; f32 sums of
# up to K = 4608 products in another order stay far inside 1e-4; bf16
# outputs may round to either neighbour, one ulp <= 2^-7 |y| (+ atol)
CONV_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-3, 1e-2)}   # (rtol, atol)
STEP_GRAD_TOL = 2.5e-2      # see cnn_step_check


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, reps: int = 30, warmup: int = 5) -> float:
    """Median time of one call in ms, by CUDA events, with L2 flushed
    (a 256 MB write) before every call: in a decode step each layer's
    pool is cold."""
    import torch

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


def ptxas_summary(log: str) -> str:
    """One line from nvcc's ``-Xptxas -v`` output: registers and spills
    over the library's kernel instantiations."""
    kernels = ptxas_kernels(log)
    regs, spills = [k[1] for k in kernels], [k[2] for k in kernels]
    return (f"{len(kernels)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{sum(x > 0 for x in spills)} with spills (max {max(spills)} bytes)")


def check_smem_formulas(flash_lib, ssd_lib, conv_lib, decode_lib) -> None:
    """The shared-memory sizes the tiling models report (what the tuner
    budgets) equal the ones the CUDA sources compute and launch with."""
    from repro_torch.kernels.conv_mm import tiling as conv_tiling
    from repro_torch.kernels.flash_attention import tiling as flash_tiling
    from repro_torch.kernels.paged_decode import tiling as pd_tiling
    from repro_torch.kernels.ssm_scan import tiling as ssm_tiling

    for dtype, flag in (("bfloat16", 1), ("float32", 0)):
        for Dh in (32, 64, 128):
            for bk in (1, 48, 64, 65, 100, 128, 256, 512, 640, 1024):
                if (flash_lib.flash_attention_smem_bytes(Dh, bk, flag)
                        != flash_tiling.smem_bytes(Dh, bk, dtype)):
                    raise AssertionError(f"flash smem formula differs at Dh={Dh} "
                                         f"block_k={bk} {dtype}")
        for bm in (64, 128):
            for bn in (64, 128):
                if conv_lib.conv_mm_smem_bytes(bm, bn, flag) != conv_tiling.smem_bytes(bm, bn, dtype):
                    raise AssertionError(f"conv_mm smem formula differs at tile "
                                         f"{bm}x{bn} {dtype}")
    for l in (16, 32, 64, 96, 100, 128, 256):
        for N, P in ((128, 64), (32, 32), (16, 8), (100, 50)):
            if ssd_lib.ssd_chunk_smem_bytes(l, N, P) != ssm_tiling.smem_bytes(l, N, P):
                raise AssertionError(f"ssd smem formula differs at l={l} N={N} P={P}")
    types = {"bfloat16": 1, "float32": 0}
    for q_dt, q_flag in types.items():
        for kv_dt, kv_flag in types.items():
            for Dh in (64, 128):
                for rep in (1, 2, 4, 5, 8, 16):
                    for bkv in (1, 8, 12, 16, 32, 64, 100, 128, 256, 512):
                        if (decode_lib.paged_decode_smem_bytes(Dh, rep, bkv, q_flag, kv_flag)
                                != pd_tiling.smem_bytes(Dh, rep, bkv, q_dt, kv_dt)):
                            raise AssertionError(
                                f"paged_decode smem formula differs at Dh={Dh} rep={rep} "
                                f"block_kv={bkv} q {q_dt} kv {kv_dt}")
    print("build shared-memory formulas of flash_attention, conv_mm, ssd_chunk and "
          "paged_decode: the CUDA sources and the tiling models agree")


def kernel_name(mangled: str) -> str:
    """``name<template arguments>`` of a mangled kernel symbol."""
    for m in re.finditer(r"\d+", mangled):
        name = mangled[m.end():m.end() + int(m.group())]
        if name.endswith("_kernel"):
            rest = mangled[m.end() + len(name):]
            args = re.findall(r"L[ib](\d+)E", rest.split("EEv")[0]) if rest[:1] == "I" else []
            return f"{name}<{', '.join(args)}>" if args else name
    return mangled


def ptxas_kernels(log: str) -> list[tuple[str, int, int]]:
    """(kernel instantiation, registers, spill-store bytes) for each entry
    function in nvcc's ``-Xptxas -v`` output."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line.split("'")[1])
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and name:
            out.append((name, int(line.split("Used")[1].split("registers")[0]), spill))
            name = None
    return out


def sass_mma_count(lib_path: str) -> dict | None:
    """Tensor-core instructions (HGMMA, HMMA) in a library's SASS, from
    ``cuobjdump -sass``; None where the tool is not available."""
    import os
    import shutil

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.isfile(tool) else shutil.which("cuobjdump")
    if not tool:
        return None
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True)
    if proc.returncode != 0:
        return None
    words = [line.split() for line in proc.stdout.splitlines()]
    return {op: sum(any(w.startswith(op + ".") or w == op for w in ws) for ws in words)
            for op in ("HGMMA", "HMMA")}


def decode_case(dtype, Dh, cache_lens, seed=0, H=None, Hkv=None):
    import torch

    d = dict(DECODE, Dh=Dh)
    B, bs, NB = d["B"], d["bs"], d["NB"]
    H, Hkv = H or d["H"], Hkv or d["Hkv"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    P = B * NB + 1                           # block 0 = scratch
    q = torch.randn(B, H, Dh, generator=g, device="cuda").to(dtype)
    kp = torch.randn(P, bs, Hkv, Dh, generator=g, device="cuda").to(dtype)
    vp = torch.randn(P, bs, Hkv, Dh, generator=g, device="cuda").to(dtype)
    bt = (torch.randperm(B * NB, generator=g, device="cuda") + 1).view(B, NB)
    cl = torch.tensor(cache_lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt.to(torch.int32), cl


def bound(q, kp, cl) -> tuple[float, str]:
    """Least time for the work these inputs need: live K/V read once, q
    read, output written (+ tables), against the flops of QK and PV."""
    B, H, Dh = q.shape
    Hkv = kp.shape[2]
    live = int((cl.long() + 1).sum())
    nbytes = (2 * Hkv * Dh * live * kp.element_size()
              + 2 * B * H * Dh * q.element_size() + 4 * (B * DECODE["NB"] + B))
    flops = 4 * H * Dh * live
    peak = BF16_FLOPS if kp.dtype.itemsize == 2 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def library_decode(q, kp, vp, bt, cl):
    """Yardstick only (never used by the port): gather the logical view,
    then one ``scaled_dot_product_attention`` call with the rep query
    heads of each KV head as its query rows."""
    import torch
    import torch.nn.functional as F

    B, H, Dh = q.shape
    Hkv = kp.shape[2]
    k = kp[bt.long()].reshape(B, -1, Hkv, Dh).transpose(1, 2)
    v = vp[bt.long()].reshape(B, -1, Hkv, Dh).transpose(1, 2)
    mask = torch.arange(k.shape[2], device=q.device)[None] <= cl[:, None]
    o = F.scaled_dot_product_attention(q.view(B, Hkv, H // Hkv, Dh), k, v,
                                       attn_mask=mask[:, None, None, :])
    return o.reshape(B, H, Dh)


def decode_check(label, args, want, **kw) -> float:
    """paged decode against its plain version on the same card inputs;
    raises outside ``TOL``, else returns the max abs error."""
    import torch

    from repro_torch.kernels.paged_decode.kernel import paged_decode_cuda

    got = paged_decode_cuda(*args, **kw)
    torch.cuda.synchronize()
    name = str(got.dtype).removeprefix("torch.")
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"paged_decode output bad at {label} {kw}")
    err = float((got.float() - want.float()).abs().max())
    if not err <= TOL[name]:
        raise AssertionError(f"paged_decode disagrees at {label} {kw}: {err}")
    return err


def kernel_phase(flush) -> dict:
    import torch

    from repro_torch.kernels import autotune
    from repro_torch.kernels.paged_decode import tiling as pd_tiling
    from repro_torch.kernels.paged_decode.kernel import paged_decode_cuda
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref

    bs, NB = DECODE["bs"], DECODE["NB"]
    edges = [0, bs - 1, bs, 2 * bs - 1, 3 * bs, 5 * bs + 17, NB * bs - 1, 700]
    # bf16 q and pools run the tensor-core kernel: every token tile the tuner
    # may return (the candidates whose ring fits), every split, rep 1, 4, 5, 8
    for Dh in (128, 64):
        for H, Hkv in ((32, 32), (32, 8), (40, 8), (32, 4)):      # rep 1, 4, 5, 8
            shape = pd_tiling.shape_key(DECODE["B"], H, Hkv, Dh, NB, bs, "bfloat16")
            tiles = sorted({c["block_kv"] for c in pd_tiling.candidates(shape)
                            if autotune.smem_ok(pd_tiling.cost(shape, c))})
            args = decode_case(torch.bfloat16, Dh, edges, H=H, Hkv=Hkv)
            want = paged_decode_ref(*args)
            err = max(decode_check(f"Dh={Dh} H={H} Hkv={Hkv} bf16", args, want,
                                   block_kv=bkv, n_splits=ns)
                      for bkv in tiles for ns in (1, 2, 4, 8))
            print(f"kernel paged_decode Dh={Dh} bfloat16 H={H} Hkv={Hkv} (rep {H // Hkv}) "
                  f"at block_kv {tiles} x n_splits [1, 2, 4, 8]: max_abs_err={err:.3e} "
                  f"(tol {TOL['bfloat16']})")
    # f32 q and pools: the CUDA-core kernel
    for Dh in (128, 64):
        args = decode_case(torch.float32, Dh, edges)
        want = paged_decode_ref(*args)
        for ns in (1, 2, 4):
            err = decode_check(f"Dh={Dh} f32", args, want, n_splits=ns)
            print(f"kernel paged_decode Dh={Dh} float32 n_splits={ns}: "
                  f"max_abs_err={err:.3e} (tol {TOL['float32']})")

    # timing at the serving shape: bf16, ragged fills drawn like the served
    # requests (prompt 64..1536 + 16 generated), at the config the tune phase
    # picked for this shape (what serving launches) and at each token tile
    # and split
    shape = pd_tiling.shape_key(DECODE["B"], DECODE["H"], DECODE["Hkv"], DECODE["Dh"],
                                NB, bs, "bfloat16")
    tuned = autotune.get_tuner().tune("paged_decode", shape)
    fills = np.random.default_rng(1).integers(64, 1537, DECODE["B"]) + 16
    args = decode_case(torch.bfloat16, DECODE["Dh"], fills.tolist(), seed=1)
    lib_err = float((library_decode(*args).float()
                     - paged_decode_ref(*args).float()).abs().max())
    ms = time_ms(lambda: paged_decode_cuda(*args, **tuned), flush)
    plain_ms = time_ms(lambda: paged_decode_ref(*args), flush)
    library_ms = time_ms(lambda: library_decode(*args), flush)
    ms_again = time_ms(lambda: paged_decode_cuda(*args, **tuned), flush)
    bound_ms, bound_by = bound(args[0], args[1], args[4])
    live = int((args[4].long() + 1).sum())
    print(f"timing paged_decode B=8 H=32 Hkv=8 Dh=128 bs=256 NB=8 bf16 "
          f"live_tokens={live} at the tuned {tuned}: kernel {ms:.4f} / "
          f"{ms_again:.4f} ms, plain {plain_ms:.4f} ms, gather+sdpa {library_ms:.4f} ms "
          f"(max_abs_err vs plain {lib_err:.3e}), bound {bound_ms:.4f} ms "
          f"({bound_by}) -> {bound_ms / ms:.1%} of bound")
    tiles = sorted({c["block_kv"] for c in pd_tiling.candidates(shape)
                    if autotune.smem_ok(pd_tiling.cost(shape, c))})
    for bkv in tiles:
        splits = {ns: time_ms(lambda: paged_decode_cuda(*args, block_kv=bkv, n_splits=ns),
                              flush) for ns in (1, 2, 4, 8)}
        print(f"timing paged_decode same inputs, block_kv={bkv}, by n_splits: " + ", ".join(
            f"{ns}: {t:.4f} ms" for ns, t in splits.items()))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def serve_phase() -> dict:
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.paged_decode import ops
    from repro_torch.kernels.paged_decode.kernel import paged_decode_cuda
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref
    from repro_torch.models import transformer as T
    from repro_torch.serve import ContinuousConfig, ContinuousEngine, Request

    cfg = get_config("qwen3-4b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    print(f"serve init_params(qwen3-4b, seed=0): {cfg.param_count() / 1e9:.3f}e9 "
          f"parameters drawn with numpy on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    scfg = ContinuousConfig(n_slots=8, max_len=2048, prefill_chunk=512)

    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1537, 16)
    prompts = [rng.integers(2, cfg.vocab, (int(n),)).astype(np.int32)
               for n in lens]

    # warm-up on a separate engine (library handles, allocator pools)
    ContinuousEngine(cfg, params, scfg).run(
        [Request(p[:100], max_new_tokens=4) for p in prompts[:2]])

    engine = ContinuousEngine(cfg, params, scfg)
    last = {}
    launch = ops.paged_decode_cuda

    def keep_last(*args, **kw):    # the served model's own kernel inputs
        last["args"], last["kw"] = args, kw
        return launch(*args, **kw)

    requests = [Request(p, max_new_tokens=32) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.paged_decode_cuda = keep_last
    paged_decode_cuda.launches = 0
    window = TunerWindow()
    t0 = time.perf_counter()
    try:
        engine.run(requests)
        torch.cuda.synchronize()
    finally:
        ops.paged_decode_cuda = launch
    wall = time.perf_counter() - t0
    launches = paged_decode_cuda.launches
    window.report("serve")
    m = engine.metrics()
    n_layers = cfg.n_layers
    print(f"serve qwen3-4b n_slots=8 max_len=2048 prefill_chunk=512 "
          f"block_size={m['block_size']} pool_blocks={engine.kv.n_blocks}: "
          f"{m['finished']}/{len(requests)} finished, lost={m['lost']}, "
          f"decode_steps={m['decode_steps']}, paged_decode launches={launches}, "
          f"preemptions={m['preemptions']}, resumes={m['resumes']}, "
          f"prefill_chunks={m['prefill_chunks']}")
    if m["finished"] != len(requests) or m["lost"] != 0:
        raise AssertionError(f"not every request finished: {m}")
    if not launches == m["decode_steps"] * n_layers > 0:
        raise AssertionError(f"paged_decode launches {launches} != "
                             f"decode_steps {m['decode_steps']} x {n_layers}")
    vocab = cfg.padded_vocab()
    for r in engine.finished:
        if not (len(r.tokens) and all(0 <= t < vocab for t in r.tokens)):
            raise AssertionError(f"request {r.rid}: bad tokens {r.tokens}")
    print(f"serve {m['tokens_out']} tokens in {wall:.3f} s = "
          f"{m['tokens_out'] / wall:.1f} tokens/s; TTFT p50 "
          f"{m['ttft_p50_ms']:.1f} ms p99 {m['ttft_p99_ms']:.1f} ms; TPOT p50 "
          f"{m['tpot_p50_ms']:.2f} ms p99 {m['tpot_p99_ms']:.2f} ms; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    q, kp, vp, bt, cl = last["args"]
    got = paged_decode_cuda(q, kp, vp, bt, cl, **last["kw"])
    want = paged_decode_ref(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and got.shape == q.shape):
        raise AssertionError("paged_decode output on served inputs not finite")
    err = float((got.float() - want.float()).abs().max())
    print(f"serve paged_decode on the served pool (last layer, last step, "
          f"cache_len={cl.tolist()}): max_abs_err={err:.3e} "
          f"(tol {TOL['bfloat16']})")
    if not err <= TOL["bfloat16"]:
        raise AssertionError(f"paged_decode disagrees on served inputs: {err}")
    del engine, last, q, kp, vp, got, want
    decode_breakdown(cfg, params, scfg, prompts)
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": err}


def decode_breakdown(cfg, params, scfg, prompts, n_steps: int = 8) -> None:
    """Where a decode step's time goes: all 8 slots decoding (prompts cut
    to 256 tokens), ``n_steps`` engine steps timed on the host clock, then
    ``n_steps`` more traced with ``torch.profiler`` (CUDA activity only)
    for the kernels' own time."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ContinuousEngine, Request

    # eos_id -1: no slot leaves early, every step decodes all 8
    engine = ContinuousEngine(cfg, params, dataclasses.replace(scfg, eos_id=-1))
    for p in prompts[:scfg.n_slots]:
        engine.submit(Request(p[:256], max_new_tokens=4 + 3 * n_steps))
    engine.step()                     # prefills every slot, then one decode
    if engine.n_running != scfg.n_slots:
        raise AssertionError("decode breakdown: not every slot is running")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    # host cost of the n_splits lookup each layer makes (a tuner memo hit),
    # as ops.paged_decode_attention makes it
    from repro_torch.kernels.autotune import tuned_config
    from repro_torch.kernels.paged_decode import tiling as pd_tiling

    t0 = time.perf_counter()
    for _ in range(1000):
        key = pd_tiling.shape_key(scfg.n_slots, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim_, 2, engine.kv.block_size, "bfloat16")
        tuned_config("paged_decode", key, pd_tiling.default(key))
    lookup_us = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + t / 1e3 / n_steps
    dev_ms = sum(by_kernel.values())
    # the tensor-core kernel (bf16) or the CUDA-core one, and the split merge
    paged = sum(t for k, t in by_kernel.items() if re.search(r"paged_decode_\w*kernel", k))
    merge = sum(t for k, t in by_kernel.items() if "combine_splits_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"decode step, 8 slots at ~256-280 tokens of context: host wall "
          f"{wall_ms:.2f} ms/step, device kernel time {dev_ms:.2f} ms/step "
          f"(device idle {1 - dev_ms / wall_ms:.1%}), paged_decode "
          f"{paged:.3f} ms/step ({paged / dev_ms:.1%} of kernel time) + its split "
          f"merge {merge:.3f} ms/step; the "
          f"n_splits lookup (a tuner memo hit) {lookup_us:.1f} us on the host, "
          f"{lookup_us * cfg.n_layers / 1e3:.3f} ms/step over {cfg.n_layers} layers")
    print("decode step top kernels (ms/step): " + "; ".join(
        f"{k[:60]} {t:.3f}" for k, t in top))


def reference_phase() -> None:
    """Reduced qwen3-4b in f32 (head_dim 64, the smallest the kernel takes;
    4 query heads over 2 KV heads): a chunked-prefill chunk and decode
    steps over the paged pool on the card (CUDA kernel) and on the CPU
    (the plain path) give the same logits.  Tolerance: atol 2e-3 (K/V sit
    in a bf16 pool, where f32 noise can flip one rounding)."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("qwen3-4b", reduced=True),
                              head_dim=64, n_kv_heads=2)
    rng = np.random.default_rng(3)
    steps = [(rng.integers(2, 512, (1, 16)), [0], [[1, 2]])]
    cl = np.array([13, 0, 7])
    for _ in range(4):
        steps.append((rng.integers(2, 512, (3, 1)), cl.tolist(),
                      [[1, 2, 3], [0, 0, 0], [4, 5, 6]]))
        cl = cl + [1, 0, 1]
    logits = {}
    for dev in ("cpu", "cuda"):
        params = T.init_params(cfg, 0, device=dev, dtype=torch.float32)
        pool = T.init_paged_cache(cfg, 9, 8, device=dev)
        out = []
        for tokens, cache_len, table in steps:
            lg, pool = T.decode_step(params, pool, {
                "tokens": torch.tensor(tokens, dtype=torch.int32, device=dev),
                "cache_len": torch.tensor(cache_len, dtype=torch.int32, device=dev),
                "block_table": torch.tensor(table, dtype=torch.int32, device=dev),
            }, cfg)
            out.append(lg.float().cpu())
        logits[dev] = out
    err = max(float((a - b).abs().max())
              for a, b in zip(logits["cpu"], logits["cuda"]))
    print(f"reference reduced qwen3-4b f32 paged decode, card vs CPU logits: "
          f"max_abs_err={err:.3e} (tol 2e-3)")
    if not err <= 2e-3:
        raise AssertionError(f"card disagrees with the CPU path: {err}")


# ---------------------------------------------------------------------------
# The kernel autotuner and the two kernels it times
# ---------------------------------------------------------------------------


def tuned_kernels() -> dict:
    """The kernels with a tiling runner, by tiling name."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.paged_decode.kernel import paged_decode_cuda
    from repro_torch.kernels.ssm_scan.kernel import ssd_chunk_cuda

    return {"flash_attention": flash_attention_cuda,
            "ssm_scan": ssd_chunk_cuda, "paged_decode": paged_decode_cuda}


class TunerWindow:
    """The process tuner's searches and the launches its timing made during
    one window of the main path (counted apart from the path's own)."""

    def __init__(self):
        from repro_torch.kernels import autotune

        self.tuner = autotune.get_tuner()
        self.misses, self.timed = self.tuner.misses, self.tuner.timed
        self.launches = {n: k.tuner_launches for n, k in tuned_kernels().items()}

    def report(self, label: str) -> None:
        extra = {n: k.tuner_launches - self.launches[n]
                 for n, k in tuned_kernels().items()}
        print(f"{label} window: tuner misses {self.tuner.misses - self.misses}, "
              f"configs timed {self.tuner.timed - self.timed}, tuner launches "
              f"(counted apart) {extra}")


def served_table_widths(blocks_per_seq: int) -> list[int]:
    """The block-table widths ``ContinuousEngine._decode_once`` passes:
    the next power of two of the blocks needed, capped at the row width."""
    widths, nb = {blocks_per_seq}, 1
    while nb < blocks_per_seq:
        widths.add(nb)
        nb *= 2
    return sorted(widths)


def tune_phase() -> dict:
    """The autotuner on the card, installed as the process default for the
    rest of the run (serve and cnn read their tuned configs from it)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.engine.devices import from_torch_device
    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attention import tiling as flash_tiling
    from repro_torch.kernels.paged_decode import tiling as pd_tiling
    from repro_torch.kernels.ssm_scan import tiling as ssm_tiling
    from repro_torch.models import transformer as T
    from repro_torch.serve.kv_cache import resolve_block_size

    path = ROOT / "build" / "repro_torch" / "tune_phase_cache.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)          # a fresh cache: every shape is searched
    spec = from_torch_device()
    tuner = autotune.KernelTuner(spec, cache=str(path), measure=True)
    autotune.set_tuner(tuner)
    kernels = tuned_kernels()
    for k in kernels.values():
        k.launches = k.tuner_launches = 0
    timed = {}
    cfg = get_config("qwen3-4b")
    t0 = time.perf_counter()

    before = tuner.timed
    warm = T.warm_autotune(cfg, batch_size=TUNE_BATCH, seq_len=TUNE_SEQ,
                           stages=("prefill", "decode"))
    timed["flash_attention"] = tuner.timed - before

    before = tuner.timed
    s = SSD_SHAPE
    ssd_key = ssm_tiling.shape_key((s["B"], s["S"], s["H"], s["P"]), s["N"],
                                   dtype="float32")
    tuner.tune("ssm_scan", ssd_key)
    timed["ssm_scan"] = tuner.timed - before

    before = tuner.timed
    bs = resolve_block_size(cfg, n_slots=8, max_len=2048)   # serve_kv, by model
    for nb in served_table_widths(-(-2048 // bs)):
        tuner.tune("paged_decode", pd_tiling.shape_key(
            8, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, nb, bs, T.DTYPE))
    timed["paged_decode"] = tuner.timed - before
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    print(f"tune spec {spec.name} (from_torch_device, fingerprint "
          f"{spec.fingerprint()}), fresh cache {path.relative_to(ROOT)}: "
          f"warm_autotune(qwen3-4b, batch {TUNE_BATCH}, seq {TUNE_SEQ}, "
          f"prefill+decode) -> {warm}; {tuner.misses} searches, "
          f"{tuner.timed} configs timed, in {wall:.1f} s")
    for e in sorted(tuner.cache.entries(),
                    key=lambda e: (e["kernel"], json.dumps(e["shape"], sort_keys=True))):
        measured = "-" if e["measured_us"] is None else f"{e['measured_us']:.1f}"
        print(f"tune {e['kernel']} {json.dumps(e['shape'], sort_keys=True)}: "
              f"config {e['config']} source {e['source']} measured_us {measured} "
              f"model_us {e['model_us']:.2f} (default {e['default_config']} "
              f"model_us {e['default_model_us']:.2f}) candidates "
              f"{e['candidates']} rejected_smem {e['rejected_vmem']} "
              f"smem_kb {e['vmem_kb']:.1f}")
        if e["kernel"] in kernels and e["source"] != "timed":
            raise AssertionError(f"{e['kernel']} was not timed: {e}")
    counts = {}
    for name, k in kernels.items():
        want = 4 * timed[name]
        print(f"tune {name}: {timed[name]} configs timed -> tuner_launches="
              f"{k.tuner_launches} (expected {want}: one warm and three timed "
              f"calls each), main-path launches={k.launches}")
        if not k.tuner_launches == want > 0 or k.launches != 0:
            raise AssertionError(f"{name} launches do not match the tuner's "
                                 f"counts: {k.tuner_launches} != {want}")
        counts[name] = k.tuner_launches
    prefill = flash_tiling.shape_key(
        (TUNE_BATCH, cfg.n_heads, TUNE_SEQ, cfg.head_dim_),
        (TUNE_BATCH, cfg.n_kv_heads, TUNE_SEQ, cfg.head_dim_),
        causal=True, dtype=T.DTYPE)
    decode = dict(prefill, Sq=1)
    ssd_tiling = autotune.get_tiling("ssm_scan")
    # the f32 kernel's own config for the kernel phase's f32 check (bf16
    # and f32 run different kernels, so their configs differ); its timing
    # launches are counted apart, after the gate above
    before, launched = tuner.timed, kernels["flash_attention"].tuner_launches
    prefill_f32 = tuner.tune("flash_attention", dict(prefill, dtype="float32"))
    print(f"tune flash_attention f32 prefill (for the kernel phase's f32 check): "
          f"config {prefill_f32}, {tuner.timed - before} configs timed, "
          f"{kernels['flash_attention'].tuner_launches - launched} tuner launches "
          f"(not in the counts above)")
    return {"launches": counts,
            "flash_prefill_f32": prefill_f32,
            "flash_prefill": tuner.tune("flash_attention", prefill),
            "flash_decode": tuner.tune("flash_attention", decode),
            "ssd_chunk": tuner.tune("ssm_scan", ssd_key)["chunk"],
            "ssd_chunks": [c["chunk"] for c in ssd_tiling.candidates(ssd_key)
                           if autotune.smem_ok(ssd_tiling.cost(ssd_key, c))]}


def flash_check(gen, label, B, H, Hkv, Sq, Sk, Dh, dtype, *, causal=True,
                q_offset=0, block_q=512, block_k=512) -> tuple[float, tuple]:
    """flash attention against its plain version on the same card inputs;
    raises outside ``FLASH_TOL``, else returns (max abs error, inputs)."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q = torch.randn(B, H, Sq, Dh, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, Sk, Dh, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, Sk, Dh, generator=gen, device="cuda").to(dtype)
    got = flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset,
                               block_q=block_q, block_k=block_k)
    want = attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    name = str(dtype).removeprefix("torch.")
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention output bad at {label}")
    err = float((got.float() - want.float()).abs().max())
    print(f"kernel flash_attention {label} B={B} H={H} Hkv={Hkv} Sq={Sq} Sk={Sk} "
          f"Dh={Dh} {name} causal={causal} q_offset={q_offset} block_q={block_q} "
          f"block_k={block_k}: max_abs_err={err:.3e} (tol {FLASH_TOL[name]})")
    if not err <= FLASH_TOL[name]:
        raise AssertionError(f"flash_attention disagrees at {label}: {err}")
    return err, (q, k, v, got)


def flash_kernel_phase(flush, tuned: dict) -> dict:
    """flash attention against its plain version at the qwen3-4b prefill
    shape (bf16 and f32, each at its tuned config), a 512-query chunk at
    q_offset 1024, decode (Sq = 1), S = 384, head dims 64 and 32 (bf16: each
    head dim is its own tensor-core instantiation) and fully masked rows,
    also with a ragged last K/V tile (Sk = 200); then kernel, plain version
    and ``scaled_dot_product_attention`` timed at the prefill shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    B, H, Hkv, S, Dh = TUNE_BATCH, 32, 8, TUNE_SEQ, 128
    pre, dec = tuned["flash_prefill"], tuned["flash_decode"]
    err, (q, k, v, _) = flash_check(gen, "qwen3-4b prefill (tuned)", B, H, Hkv, S, S,
                                    Dh, torch.bfloat16, **pre)
    flash_check(gen, "qwen3-4b prefill (tuned for f32)", B, H, Hkv, S, S, Dh,
                torch.float32, **tuned["flash_prefill_f32"])
    flash_check(gen, "qwen3-4b prefill (default blocks)", B, H, Hkv, S, S, Dh,
                torch.bfloat16)
    flash_check(gen, "512-query chunk", B, H, Hkv, 512, S, Dh, torch.bfloat16,
                q_offset=1024)
    flash_check(gen, "decode (tuned)", B, H, Hkv, 1, S, Dh, torch.bfloat16,
                q_offset=S - 1, **dec)
    for dtype in (torch.float32, torch.bfloat16):
        flash_check(gen, "S=384", 2, H, Hkv, 384, 384, Dh, dtype)
    flash_check(gen, "bidirectional Dh=64", 2, 16, 4, 200, 300, 64, torch.float32,
                causal=False, block_q=100, block_k=150)
    flash_check(gen, "bidirectional Dh=64", 2, 16, 4, 200, 300, 64, torch.bfloat16,
                causal=False, block_q=100, block_k=150)
    flash_check(gen, "Dh=32", 2, 8, 2, 256, 256, 32, torch.bfloat16, block_q=128,
                block_k=64)
    # fully masked rows (q_offset -4) return mean(V): Sk 256 fills whole
    # tiles, Sk 200 leaves a ragged last tile whose missing keys weigh 0
    masked = [("float32", 256), ("bfloat16", 200), ("float32", 200)]
    for name, Sk in masked:
        _, (mq, mk, mv, mo) = flash_check(gen, "rows 0-3 fully masked", 1, H, Hkv, 64,
                                          Sk, Dh, getattr(torch, name), q_offset=-4,
                                          block_q=64, block_k=64)
        mean_err = float((mo[:, :, :4].float()
                          - mv.repeat_interleave(H // Hkv, 1).float().mean(2, keepdim=True)
                          ).abs().max())
        print(f"kernel flash_attention fully masked rows Sk={Sk} {name} against "
              f"mean(V): max_abs_err={mean_err:.3e} (tol {FLASH_TOL[name]})")
        if not mean_err <= FLASH_TOL[name]:
            raise AssertionError(f"fully masked rows are not mean(V): {mean_err}")

    kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    lib_err = float((F.scaled_dot_product_attention(q, kr, vr, is_causal=True).float()
                     - attention_ref(q, k, v).float()).abs().max())
    ms = time_ms(lambda: flash_attention_cuda(q, k, v, **pre), flush, 10, 2)
    plain_ms = time_ms(lambda: attention_ref(q, k, v), flush, 5, 1)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True),
                         flush, 10, 2)
    ms_again = time_ms(lambda: flash_attention_cuda(q, k, v, **pre), flush, 10, 2)
    flops = 4 * B * H * S * S * Dh * 0.5
    nbytes = 2 * (2 * B * H * S * Dh + 2 * B * Hkv * S * Dh)
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"timing flash_attention qwen3-4b prefill B={B} H={H} Hkv={Hkv} S={S} "
          f"Dh={Dh} bf16 causal at {pre}: kernel {ms:.4f} / {ms_again:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {library_ms:.4f} ms (max_abs_err vs plain "
          f"{lib_err:.3e}), bound {bound_ms:.4f} ms ({bound_by}) -> "
          f"{bound_ms / ms:.1%} of bound")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def ssd_kernel_phase(flush, tuned: dict) -> dict:
    """The SSD intra-chunk kernel against its plain version at the
    mamba2-780m shape (f32) for every chunk the tuner may return, and the
    whole op (kernel + recurrence) against ``ssd_ref`` with an initial
    state and split in two halves; the same with bf16 inputs; then kernel
    and plain version timed at the tuned chunk."""
    import torch

    from repro_torch.kernels.ssm_scan.kernel import ssd_chunk_cuda
    from repro_torch.kernels.ssm_scan.ops import ssd
    from repro_torch.kernels.ssm_scan.ref import ssd_chunk_ref, ssd_ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    B, S, H, P, N = (SSD_SHAPE[k] for k in ("B", "S", "H", "P", "N"))
    xh = torch.randn(B, S, H, P, generator=gen, device="cuda")
    a = -torch.randn(B, S, H, generator=gen, device="cuda").abs() * 0.1
    Bm = torch.randn(B, S, N, generator=gen, device="cuda")
    Cm = torch.randn(B, S, N, generator=gen, device="cuda")
    s0 = torch.randn(B, H, P, N, generator=gen, device="cuda") * 0.1
    worst = 0.0
    for ch in tuned["ssd_chunks"]:
        got = ssd_chunk_cuda(xh, a, Bm, Cm, chunk=ch)
        want = ssd_chunk_ref(xh, a, Bm, Cm, chunk=ch)
        y, st = ssd(xh, a, Bm, Cm, chunk=ch, initial_state=s0)
        y_ref, st_ref = ssd_ref(xh, a, Bm, Cm, chunk=ch, initial_state=s0)
        half = S // 2
        y1, st1 = ssd(*(t[:, :half] for t in (xh, a, Bm, Cm)), chunk=ch,
                      initial_state=s0)
        y2, st2 = ssd(*(t[:, half:] for t in (xh, a, Bm, Cm)), chunk=ch,
                      initial_state=st1)
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in (*got, y, st, y2, st2)):
            raise AssertionError(f"ssd output not finite at chunk {ch}")
        errs = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
        op_err = max(float((y - y_ref).abs().max()), float((st - st_ref).abs().max()))
        split_err = max(float((torch.cat([y1, y2], 1) - y_ref).abs().max()),
                        float((st2 - st_ref).abs().max()))
        print(f"kernel ssd_chunk B={B} S={S} H={H} P={P} N={N} f32 chunk={ch}: "
              f"max_abs_err y_diag {errs[0]:.3e} states {errs[1]:.3e} decay "
              f"{errs[2]:.3e} cum {errs[3]:.3e}; ssd op with initial_state vs "
              f"ssd_ref {op_err:.3e}, two halves chained {split_err:.3e} "
              f"(tol {SSD_TOL}; |y| up to {float(y_ref.abs().max()):.1f})")
        if not max(*errs, op_err, split_err) <= SSD_TOL:
            raise AssertionError(f"ssd_chunk disagrees at chunk {ch}")
        if ch == tuned["ssd_chunk"]:
            worst = max(errs)

    # bf16 x, B and C (converted to f32 on load, the same 3xTF32 path): the f32
    # outputs, and the op's final state, within SSD_TOL of the plain version on
    # the same inputs; y_diag rounds to bf16 on both sides, so it may land one
    # bf16 ulp (<= 2^-7 |y|) apart
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (xh, Bm, Cm))
    for ch in tuned["ssd_chunks"]:
        got = ssd_chunk_cuda(xb, a, Bb, Cb, chunk=ch)
        want = ssd_chunk_ref(xb, a, Bb, Cb, chunk=ch)
        _, st = ssd(xb, a, Bb, Cb, chunk=ch, initial_state=s0)
        _, st_ref = ssd_ref(xb, a, Bb, Cb, chunk=ch, initial_state=s0)
        torch.cuda.synchronize()
        if not (got[0].dtype == torch.bfloat16
                and all(torch.isfinite(t).all() for t in (*got, st))):
            raise AssertionError(f"ssd bf16 output bad at chunk {ch}")
        errs = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
        y_excess = float(((got[0].float() - want[0].float()).abs()
                          - 2.0 ** -7 * want[0].float().abs()).max())
        st_err = float((st - st_ref).abs().max())
        print(f"kernel ssd_chunk B={B} S={S} H={H} P={P} N={N} bf16 inputs chunk={ch}: "
              f"max_abs_err states {errs[1]:.3e} decay {errs[2]:.3e} cum {errs[3]:.3e}, "
              f"ssd op final state vs ssd_ref {st_err:.3e}; y_diag {errs[0]:.3e}, "
              f"beyond one bf16 ulp {y_excess:.3e} (tol {SSD_TOL})")
        if not max(*errs[1:], st_err, y_excess) <= SSD_TOL:
            raise AssertionError(f"ssd_chunk with bf16 inputs disagrees at chunk {ch}")

    ch = tuned["ssd_chunk"]
    ms = time_ms(lambda: ssd_chunk_cuda(xh, a, Bm, Cm, chunk=ch), flush, 20, 3)
    plain_ms = time_ms(lambda: ssd_chunk_ref(xh, a, Bm, Cm, chunk=ch), flush, 10, 2)
    op_ms = time_ms(lambda: ssd(xh, a, Bm, Cm, chunk=ch), flush, 10, 2)
    ms_again = time_ms(lambda: ssd_chunk_cuda(xh, a, Bm, Cm, chunk=ch), flush, 20, 3)
    # least work: C·Bᵀ once per chunk (the heads share one group), then per
    # head the lower triangle of (s∘L)·x and the (N, P) state
    nc, tri = S // ch, ch * (ch + 1) / 2
    flops = 2 * B * nc * (tri * N + H * (tri * P + ch * N * P))
    nbytes = 4 * (2 * B * S * H * P + 2 * B * S * N + 2 * B * S * H
                  + B * nc * H * (N * P + 1))
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"timing ssd_chunk mamba2-780m B={B} S={S} H={H} P={P} N={N} f32 at the "
          f"tuned chunk {ch}: kernel {ms:.4f} / {ms_again:.4f} ms, plain {plain_ms:.4f} "
          f"ms, whole op (kernel + recurrence) {op_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}) -> {bound_ms / ms:.1%} of bound; no single PyTorch call "
          f"computes it")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# ---------------------------------------------------------------------------
# The CNN toolflow and its convolution kernel
# ---------------------------------------------------------------------------

# edge cases of tests/test_kernels.py (5x5 stride 2, valid padding, C = 3,
# 1x1) and an O that is no multiple of the 64-wide tile:
# (N, H, W, C, K, O, stride, padding)
CONV_EDGES = [(2, 8, 8, 8, 3, 16, 1, 1), (1, 16, 16, 4, 3, 8, 2, 1),
              (2, 8, 8, 16, 1, 32, 1, 0), (1, 9, 9, 8, 5, 8, 2, 2),
              (2, 8, 8, 3, 3, 8, 1, 0), (3, 7, 5, 13, 3, 70, 1, 1)]
GRID_BS = (2, 16, 64, 128, 256)


def conv_nodes(model) -> list:
    """((H, W, C) of the input, node) for every groups = 1 convolution of
    the model's graph, in the order ``apply`` runs them (Dense layers and
    depthwise convolutions do not go through the kernel)."""
    from repro_torch.models import cnn

    found = []

    def walk(node, s):
        if isinstance(node, cnn.Seq):
            for n in node.nodes:
                s = walk(n, s)
            return s
        if isinstance(node, cnn.Residual):
            out = walk(node.body, s)
            if node.shortcut is not None:
                walk(node.shortcut, s)
            return out
        if isinstance(node, cnn.Concat):
            for b in node.branches:
                walk(b, s)
        elif isinstance(node, cnn.C) and not node.depthwise:
            found.append((s, node))
        return node.out_shape(s)

    walk(model.graph, (model.input_hw, model.input_hw, 3))
    return found


def conv_shape(s, node) -> tuple:
    """(H, W, C, K, O, stride, padding) of one convolution."""
    return (*s, node.k, node.out, node.stride, node.pad)


def conv_bound(N, H, W, C, K, O, stride, pad, itemsize=4) -> tuple[float, str, float]:
    """(bound ms, what bounds it, ms at the TF32 tensor-core peak): x and
    w read once and y written once, against 2·N·OH·OW·K·K·C·O flops at the
    f32 peak."""
    OH, OW = 1 + (H + 2 * pad - K) // stride, 1 + (W + 2 * pad - K) // stride
    nbytes = itemsize * (N * H * W * C + K * K * C * O + N * OH * OW * O)
    flops = 2 * N * OH * OW * K * K * C * O
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            max(t_bytes, flops / TF32_FLOPS) * 1e3)


def conv_inputs(gen, N, H, W, C, K, O, dtype):
    """x ~ N(0, 1) and w ~ N(0, 1/(K·K·C)), so outputs have unit variance."""
    import torch

    x = torch.randn(N, H, W, C, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(K, K, C, O, generator=gen, device="cuda")
         / (K * K * C) ** 0.5).to(dtype)
    return x, w


def conv_check(x, w, stride: int, padding: int) -> float:
    """conv_mm against its plain version on the same card inputs; raises
    outside ``CONV_TOL``, else returns the max abs error."""
    import torch

    from repro_torch.kernels.conv_mm.kernel import conv_mm_cuda
    from repro_torch.kernels.conv_mm.ref import conv_ref

    got = conv_mm_cuda(x, w, stride=stride, padding=padding)
    want = conv_ref(x, w, stride=stride, padding=padding)
    torch.cuda.synchronize()
    where = (tuple(x.shape), tuple(w.shape), stride, padding, str(x.dtype))
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"conv_mm output bad at {where}")
    rtol, atol = CONV_TOL[str(x.dtype).removeprefix("torch.")]
    diff = (got.float() - want.float()).abs()
    if (diff > atol + rtol * want.float().abs()).any():
        raise AssertionError(f"conv_mm disagrees at {where}: "
                             f"max_abs_err {float(diff.max()):.3e}")
    return float(diff.max())


def conv_kernel_phase(flush) -> dict:
    """conv_mm against its plain version on every distinct convolution
    shape of full-width ResNet-50 (bs 32) and on the edge cases, f32 and
    bf16; then times at bs 128, each shape first held against the plain
    version in f32: three named shapes, and the sum over the 53
    convolutions of one forward pass."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.conv_mm.kernel import conv_mm_cuda
    from repro_torch.kernels.conv_mm.ref import conv_ref
    from repro_torch.models.cnn import build_resnet50

    convs = conv_nodes(build_resnet50(width_mult=1.0, input_hw=32))
    counts: dict = {}
    for s, node in convs:
        counts[conv_shape(s, node)] = counts.get(conv_shape(s, node), 0) + 1
    print(f"kernel conv_mm: ResNet-50 (width 1.0, 32x32) runs {len(convs)} "
          f"groups=1 convolutions of {len(counts)} distinct shapes")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, cases in (("resnet50 shapes bs=32", [(32, *k) for k in counts]),
                         ("edge cases", CONV_EDGES)):
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            rtol, atol = CONV_TOL[name]
            err = 0.0
            for N, H, W, C, K, O, s, p in cases:
                x, w = conv_inputs(gen, N, H, W, C, K, O, dtype)
                err = max(err, conv_check(x, w, s, p))
            print(f"kernel conv_mm {label} {name}: {len(cases)} shapes, "
                  f"max_abs_err={err:.3e} (rtol {rtol}, atol {atol})")

    def three(x, w, s, p, reps=30, warmup=5):
        # the yardstick gets NCHW views of the same NHWC x (cuDNN's
        # channels-last path) and its weight laid out once outside the clock
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib_err = float((F.conv2d(xc, wc, stride=s, padding=p).permute(0, 2, 3, 1)
                         - conv_ref(x, w, stride=s, padding=p)).abs().max())
        return (time_ms(lambda: conv_mm_cuda(x, w, stride=s, padding=p), flush, reps, warmup),
                time_ms(lambda: conv_ref(x, w, stride=s, padding=p), flush, reps, warmup),
                time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p), flush, reps, warmup),
                lib_err)

    for label, (H, W, C, K, O, s, p) in (
            ("largest 3x3", (32, 32, 64, 3, 64, 1, 1)),
            ("largest 1x1", (4, 4, 512, 1, 2048, 1, 0)),
            ("stem", (32, 32, 3, 3, 64, 1, 1))):
        x, w = conv_inputs(gen, 128, H, W, C, K, O, torch.float32)
        ms, plain, lib, lib_err = three(x, w, s, p)
        bound_ms, by, tf32_ms = conv_bound(128, H, W, C, K, O, s, p)
        print(f"timing conv_mm {label} N=128 {H}x{W} C={C} K={K} O={O} s={s} p={p} f32: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, F.conv2d (cuDNN, no TF32) "
              f"{lib:.4f} ms (max_abs_err vs plain {lib_err:.3e}), bound {bound_ms:.4f} ms "
              f"({by}) -> {bound_ms / ms:.1%} of bound; at the TF32 tensor-core peak "
              f"{tf32_ms:.4f} ms")

    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    by_ops = by_bytes = 0.0
    for (H, W, C, K, O, s, p), n in counts.items():
        x, w = conv_inputs(gen, 128, H, W, C, K, O, torch.float32)
        conv_check(x, w, s, p)
        ms, plain, lib, _ = three(x, w, s, p, reps=10, warmup=2)
        bound_ms, by, _ = conv_bound(128, H, W, C, K, O, s, p)
        for key, v in zip(total, (ms, plain, lib, bound_ms)):
            total[key] += n * v
        by_ops += n * bound_ms if by == "operations" else 0.0
        by_bytes += n * bound_ms if by == "bytes" else 0.0
    total["bound_by"] = "operations" if by_ops >= by_bytes else "bytes"
    print(f"timing conv_mm all {len(convs)} convolutions of one ResNet-50 forward, "
          f"N=128 32x32 f32: kernel {total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, "
          f"F.conv2d {total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms "
          f"({by_ops:.3f} ms of it bound by operations, {by_bytes:.3f} ms by bytes) "
          f"-> {total['bound_ms'] / total['ms']:.1%} of bound")
    return total


def cnn_step_check() -> None:
    """One SGD-momentum step of a reduced ResNet-50 (width 0.25, 16x16,
    bs 8, seed 0, zero momentum) on the card (the kernel, cuDNN backward)
    and on the CPU (the plain version), both f32, against the same step on
    the CPU in float64, the exact result.

    Tolerances, as relative errors in the Euclidean norm over all arrays:
    the loss 1e-4 (the forward pass is well-conditioned); the momentum,
    i.e. the gradients, ``STEP_GRAD_TOL``; the parameters move by lr·g, so
    they carry the gradients' tolerance scaled by lr·‖g‖/‖p‖ (+ 1e-6).  Batch-statistics BatchNorm makes these gradients
    ill-conditioned: the reference's own f32 gradients at this
    configuration are 2.5e-2 away from float64 (pinned by
    ``tests/test_torch_toolflow.py::test_reduced_resnet50_step_conditioning``),
    and any other f32 summation order lands about as far.  A fourth step,
    on the card with the forward convolutions run by the plain version
    instead of the kernel (cuDNN backward as before), is printed beside
    them and gates nothing: the two card readings differ only in the
    forward's summation order."""
    import torch

    from repro_torch.convert import cnn_params_from_numpy, tree_leaves, tree_map
    from repro_torch.core.profiler import make_train_step
    from repro_torch.kernels.conv_mm import ops
    from repro_torch.kernels.conv_mm.ref import conv_ref
    from repro_torch.models.cnn import build_resnet50

    model = build_resnet50(width_mult=0.25, input_hw=16)
    init = model.init(0)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 100, size=(8,)).astype(np.int32)
    out = {}
    kernel_forward = ops._forward
    for name, dev, dtype in (("exact", "cpu", torch.float64),
                             ("cpu", "cpu", torch.float32),
                             ("card", "cuda", torch.float32),
                             ("card, plain forward", "cuda", torch.float32)):
        params = tree_map(lambda t: t.to(dtype), cnn_params_from_numpy(init, device=dev))
        mom = tree_map(torch.zeros_like, params)
        if name == "card, plain forward":
            ops._forward = lambda x_, w_, s_, p_: conv_ref(x_, w_, stride=s_, padding=p_)
        try:
            params, mom, loss = make_train_step(model)(
                params, mom, torch.tensor(x, dtype=dtype, device=dev),
                torch.tensor(y, device=dev))
        finally:
            ops._forward = kernel_forward
        out[name] = {part: [t.detach().double().cpu().numpy() for t in tensors]
                     for part, tensors in (("params", tree_leaves(params)),
                                           ("momentum", tree_leaves(mom)),
                                           ("loss", [loss]))}

    def rel(name, part):
        num = sum(np.linalg.norm(a - e) ** 2 for a, e in zip(out[name][part], out["exact"][part]))
        return float(np.sqrt(num / sum(np.linalg.norm(e) ** 2 for e in out["exact"][part])))

    def norm(part):
        return float(np.sqrt(sum(np.linalg.norm(e) ** 2 for e in out["exact"][part])))

    step_share = 0.01 * norm("momentum") / norm("params")      # lr·‖g‖/‖p‖
    tols = {"params": step_share * STEP_GRAD_TOL + 1e-6, "momentum": STEP_GRAD_TOL,
            "loss": 1e-4}
    print("cnn step reduced ResNet-50 (width 0.25, 16x16, bs 8), relative error against "
          "the float64 step: " + "; ".join(
              f"{part} card {rel('card', part):.3e} / card with the plain forward "
              f"{rel('card, plain forward', part):.3e} / CPU {rel('cpu', part):.3e} "
              f"(tol {tol:.3e})" for part, tol in tols.items()))
    for part, tol in tols.items():
        if not rel("card", part) <= tol:
            raise AssertionError(f"card step {part} off the exact step: {rel('card', part):.3e}")


def cnn_toolflow(repeats: int = 5, warmup: int = 2) -> dict:
    """Full-width ResNet-50 through the paper's toolflow on the card:
    prune, profile Γ/Φ per (level, batch size), cache, fit, predict."""
    import torch

    from repro_torch.core.dataset import (DEFAULT_TEST_LEVELS, PAPER_TRAIN_LEVELS,
                                          DatasetCache, GridSpec, _build_pruned,
                                          collect_grid)
    from repro_torch.core.predictor import Perf4Sight
    from repro_torch.kernels.conv_mm.kernel import conv_mm_cuda

    grids = {
        "train random": GridSpec("resnet50", PAPER_TRAIN_LEVELS, "random", GRID_BS, 1.0, 32),
        "test random": GridSpec("resnet50", DEFAULT_TEST_LEVELS, "random", GRID_BS, 1.0, 32),
        "test l1": GridSpec("resnet50", DEFAULT_TEST_LEVELS, "l1", GRID_BS, 1.0, 32),
    }
    shapes = {(name, lv): [conv_shape(*c) for c in conv_nodes(_build_pruned(spec, lv))]
              for name, spec in grids.items() for lv in spec.levels}
    n_convs = {key: len(v) for key, v in shapes.items()}
    steps = 2 + warmup + repeats          # profile_training's steps per datapoint
    expected = sum(n_convs.values()) * len(GRID_BS) * steps
    path = ROOT / "build" / "repro_torch" / "cnn_profile_resnet50.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)          # a fresh cache: every point is profiled
    cache = DatasetCache(str(path))

    torch.cuda.synchronize()
    conv_mm_cuda.launches = 0
    window = TunerWindow()
    t0 = time.perf_counter()
    points = {name: collect_grid(spec, cache, repeats=repeats, warmup=warmup,
                                 device="cuda")
              for name, spec in grids.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = conv_mm_cuda.launches
    window.report("cnn grid")
    n_points = sum(map(len, points.values()))
    print(f"cnn grid ResNet-50 width 1.0 32x32 f32, batch sizes {list(GRID_BS)}, "
          f"repeats={repeats} warmup={warmup}: {n_points} datapoints profiled in "
          f"{wall:.1f} s; conv_mm launches={launches} (expected "
          f"{expected} = sum of groups=1 convolutions over the profiled topologies "
          f"x {len(GRID_BS)} batch sizes x {steps} steps); cache {path.relative_to(ROOT)}")
    if launches != expected:
        raise AssertionError(f"conv_mm launches {launches} != {expected}")
    # the kernel against its plain version at every shape the grid gave it
    # (after the count was read: these launches are not the main path's)
    distinct = sorted({(bs, *k) for v in shapes.values() for k in v for bs in GRID_BS})
    gen = torch.Generator(device="cuda").manual_seed(1)
    t1 = time.perf_counter()
    err = 0.0
    for N, H, W, C, K, O, s, p in distinct:
        x, w = conv_inputs(gen, N, H, W, C, K, O, torch.float32)
        err = max(err, conv_check(x, w, s, p))
    del x, w
    print(f"kernel conv_mm every shape of the grid ({len(distinct)} distinct "
          f"(batch size, convolution) pairs over {len(shapes)} topologies) float32: "
          f"max_abs_err={err:.3e} (rtol {CONV_TOL['float32'][0]}, atol "
          f"{CONV_TOL['float32'][1]}) in {time.perf_counter() - t1:.1f} s")
    for name, spec in grids.items():
        for lv in spec.levels:
            row = [dp for dp in points[name] if dp.level == lv]
            if not all(np.isfinite([dp.gamma_mb, dp.phi_ms]).all() and dp.gamma_mb > 0
                       and dp.phi_ms > 0 and len(dp.features) == 42 for dp in row):
                raise AssertionError(f"bad datapoint in {name} level {lv}")
            print(f"cnn grid {name} level {lv:.2f} ({n_convs[name, lv]} convs): "
                  "phi_ms " + " ".join(f"{dp.phi_ms:.3f}" for dp in row)
                  + " | gamma_mb " + " ".join(f"{dp.gamma_mb:.1f}" for dp in row))
    if len(cache) != n_points:
        raise AssertionError("cache does not hold every datapoint")

    model = Perf4Sight().fit(points["train random"])
    for name in ("test random", "test l1"):
        rep = model.evaluate(points[name])
        print(f"cnn predictor fitted on {len(points['train random'])} train points, "
              f"{name} ({rep.n} points): Γ MAPE {rep.gamma_mape:.2%}, "
              f"Φ MAPE {rep.phi_mape:.2%}")
        if not (np.isfinite(rep.gamma_mape) and np.isfinite(rep.phi_mape)):
            raise AssertionError("predictor errors are not finite")
    return {"launches": launches, "max_abs_err": err, "points": points,
            "forest": model, "cache": str(path), "train_grid": grids["train random"]}


def cnn_step_breakdown(bs: int = 128, n_steps: int = 5) -> None:
    """Where one full-width ResNet-50 training step's time goes at bs 128:
    ``n_steps`` steps on the host clock, then ``n_steps`` more traced with
    ``torch.profiler`` for the kernels' own time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.convert import cnn_params_from_numpy, tree_map
    from repro_torch.core.profiler import make_train_step
    from repro_torch.models.cnn import build_resnet50

    model = build_resnet50(width_mult=1.0, input_hw=32)
    params = cnn_params_from_numpy(model.init(0), device="cuda")
    mom = tree_map(torch.zeros_like, params)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(bs, 32, 32, 3)).astype(np.float32), device="cuda")
    y = torch.tensor(rng.integers(0, 100, size=(bs,)).astype(np.int32), device="cuda")
    step = make_train_step(model)
    for _ in range(2):
        step(params, mom, x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step(params, mom, x, y)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step(params, mom, x, y)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = {e.key: e.self_device_time_total / 1e3 / n_steps
               for e in events if e.device_type == DeviceType.CUDA}
    dev_ms = sum(kernels.values())
    conv = sum(t for k, t in kernels.items() if re.search(r"conv_mm_\w+_kernel", k))
    bwd = sum(e.device_time_total for e in events
              if e.key == "aten::convolution_backward") / 1e3 / n_steps
    if not dev_ms > 0:
        raise AssertionError("the profiler saw no device time")
    print(f"cnn step ResNet-50 width 1.0 32x32 bs {bs}: host wall {wall_ms:.2f} ms/step, "
          f"device kernel time {dev_ms:.2f} ms/step (device idle {1 - dev_ms / wall_ms:.1%}); "
          f"conv_mm {conv:.2f} ms ({conv / dev_ms:.1%}), convolution backward "
          f"(cuDNN) {bwd:.2f} ms ({bwd / dev_ms:.1%}), the rest "
          f"{dev_ms - conv - bwd:.2f} ms ({(dev_ms - conv - bwd) / dev_ms:.1%})")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print("cnn step top kernels (ms/step): " + "; ".join(f"{k[:70]} {t:.3f}" for k, t in top))


def cnn_phase() -> dict:
    t0 = time.perf_counter()
    cnn_step_check()
    result = cnn_toolflow()
    cnn_step_breakdown()
    print(f"cnn phase done in {time.perf_counter() - t0:.1f} s")
    return result


# ---------------------------------------------------------------------------
# The cost engine, calibration and the §6.4 evolutionary search
# ---------------------------------------------------------------------------

# benchmarks/table2_case_study.py's protocol at full width: sub-networks
# sampled from seeds 2000 + i, 10 to fit the inference forest and 6 to test
# it, profiled for inference at four batch sizes and once for training at
# the search's batch size; the reference runner's search size (the paper's
# is population 100 x 500 iterations)
N_TRAIN_SUB, N_TEST_SUB = 10, 6
INFER_BS = (1, 2, 4, 8)
SEARCH_TRAIN_BS, SEARCH_INFER_BS = 16, 1
SEARCH = dict(population=32, iterations=40, seed=0)
# Every profile of the phase (sub-networks, winners) takes the median of
# 10 steps after 2 warm-up steps: more than the reference runner's
# profiler defaults (3 and 1 for inference, 2 and 1 for training), since
# φ at bs 1 on the card is host time.  A profile runs
# 2 + warmup + repeats steps, each launching conv_mm once per groups = 1
# convolution.
PROFILE = dict(repeats=10, warmup=2)
PROFILE_STEPS = 2 + PROFILE["warmup"] + PROFILE["repeats"]
# a budgeted tier leaves at least this many candidates of the search's
# first population feasible, as the engine predicts them
FEASIBLE_FIRST = 4


def search_fields(r) -> dict:
    """A SearchResult's fields, all but its wall time."""
    import dataclasses

    d = dataclasses.asdict(r)
    d.pop("search_time_s")
    return d


def positive(label: str, *values) -> None:
    if not (np.isfinite(values).all() and min(values) > 0):
        raise AssertionError(f"{label}: not finite and positive: {values}")


def engine_phase(cnn: dict) -> dict:
    """Paper §6.4 on the card, through the port's cost engine: an
    analytical spec of this card calibrated on the cnn phase's train grid
    (served from its cache), the inference forest fitted on profiled
    ResNet-50 sub-networks, the evolutionary search under three budget
    tiers, each winner profiled through the engine, and the search
    repeated from its cache."""
    import torch

    from repro_torch.core.dataset import DatasetCache
    from repro_torch.core.features import network_features
    from repro_torch.core.predictor import Perf4Sight, mape
    from repro_torch.core.profiler import profile_inference, profile_training
    from repro_torch.core.search import (Constraints, evolutionary_search,
                                         sample_subnetwork)
    from repro_torch.engine import (AnalyticalBackend, CalibrationWorkload,
                                    CostEngine, CostQuery, EnsembleBackend,
                                    EstimateCache, ForestBackend, ProfilerBackend,
                                    calibrate, evaluate_accuracy, from_torch_device,
                                    measure_ground_truth)
    from repro_torch.kernels import autotune
    from repro_torch.kernels.conv_mm.kernel import conv_mm_cuda
    from repro_torch.models.cnn import build_resnet50

    grid = cnn["train_grid"]
    wm, hw = grid.width_mult, grid.input_hw
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    conv_mm_cuda.launches = 0
    expected = 0
    window = TunerWindow()

    # 1. calibrate an analytical spec of this card on the cnn phase's grid
    profiler = ProfilerBackend(**PROFILE)
    workloads = [CalibrationWorkload(grid.family, lv, bs, strategy=grid.strategy,
                                     width_mult=wm, input_hw=hw, seed=grid.seed)
                 for lv in grid.levels for bs in grid.batch_sizes]
    dps, profiled = measure_ground_truth(profiler, workloads, DatasetCache(cnn["cache"]))
    print(f"engine calibration ground truth: {len(workloads)} workloads "
          f"({grid.family} width {wm} {hw}x{hw}, levels {list(grid.levels)} x batch "
          f"sizes {list(grid.batch_sizes)}), {len(workloads) - profiled} from the cnn "
          f"phase's cache, profiled {profiled}")
    if profiled != 0 or len(dps) != len(workloads):
        raise AssertionError("calibration must be served from the cnn phase's cache")
    analytical = AnalyticalBackend(device=from_torch_device())
    tests = {name: cnn["points"][name] for name in ("test random", "test l1")}
    before = {name: evaluate_accuracy(analytical, pts) for name, pts in tests.items()}
    tuning = autotune.get_tuner().cache
    spec = calibrate(analytical, profiler, workloads, datapoints=dps, tuning_cache=tuning)
    consts = {f: getattr(spec, f) for f in ("peak_flops", "hbm_bw", "launch_overhead_s",
                                            "mem_base_mb", "mem_weight_scale",
                                            "mem_act_scale")}
    print(f"engine calibrated spec {spec.name} (fingerprint {spec.fingerprint()}): "
          + ", ".join(f"{k}={v:.6g}" for k, v in consts.items())
          + f", combine={spec.combine}, class_coeffs={json.dumps(spec.class_coeffs)}, "
          f"meta={json.dumps(spec.meta)}")
    if not (spec.calibrated and np.isfinite(list(consts.values())).all() and min(consts.values()) >= 0):
        raise AssertionError(f"bad calibrated spec: {spec}")
    forest = ForestBackend(train=cnn["forest"])
    for name, pts in tests.items():
        after, tree = evaluate_accuracy(analytical, pts), evaluate_accuracy(forest, pts)
        print(f"engine accuracy on {name} ({after['n']} points): analytical "
              f"uncalibrated Φ MAPE {before[name]['phi_mape']:.2%} Γ MAPE "
              f"{before[name]['gamma_mape']:.2%}; calibrated Φ MAPE "
              f"{after['phi_mape']:.2%} Γ MAPE {after['gamma_mape']:.2%}; forest "
              f"Φ MAPE {tree['phi_mape']:.2%} Γ MAPE {tree['gamma_mape']:.2%}")
        positive(f"accuracy on {name}", after["phi_mape"], after["gamma_mape"],
                 tree["phi_mape"], tree["gamma_mape"])

    # 2. the inference forest, on profiled sub-networks
    base = build_resnet50(width_mult=wm, input_hw=hw)
    rows = []
    t1 = time.perf_counter()
    for i in range(N_TRAIN_SUB + N_TEST_SUB):
        m = build_resnet50(widths=sample_subnetwork(base.widths,
                                                    np.random.default_rng(2000 + i)),
                           input_hw=hw)
        net, steps = m.conv_specs(), len(conv_nodes(m)) * PROFILE_STEPS
        for stage, bs in [("infer", b) for b in INFER_BS] + [("train", SEARCH_TRAIN_BS)]:
            prof = profile_inference if stage == "infer" else profile_training
            t = time.perf_counter()
            res = prof(m, bs, **PROFILE)
            rows.append({"sub": i, "bs": bs, "stage": stage, "gamma": res.gamma_mb,
                         "phi": res.phi_ms, "profile_s": time.perf_counter() - t,
                         "features": network_features(net, bs)})
            expected += steps
            positive(f"sub-network {i} {stage} bs {bs}", res.gamma_mb, res.phi_ms)
    infer_rows = [r for r in rows if r["stage"] == "infer"]
    fit = [r for r in infer_rows if r["sub"] < N_TRAIN_SUB]
    held = [r for r in infer_rows if r["sub"] >= N_TRAIN_SUB]
    infer_model = Perf4Sight(n_estimators=100, seed=0).fit_arrays(
        np.array([r["features"] for r in fit]), np.array([r["gamma"] for r in fit]),
        np.array([r["phi"] for r in fit]))
    pg, pp = infer_model.predict_features(np.array([r["features"] for r in held]))
    g_err = mape(pg, np.array([r["gamma"] for r in held]))
    p_err = mape(pp, np.array([r["phi"] for r in held]))
    train_rows = [r for r in rows if r["stage"] == "train"]
    pt, _ = cnn["forest"].predict_features(np.array([r["features"] for r in train_rows]))
    gt_err = mape(pt, np.array([r["gamma"] for r in train_rows]))
    mean_profile_s = float(np.mean([r["profile_s"] for r in rows]))
    print(f"engine sub-networks: {len(rows)} profiles of {N_TRAIN_SUB + N_TEST_SUB} "
          f"ResNet-50 sub-networks (seeds 2000..{1999 + N_TRAIN_SUB + N_TEST_SUB}; "
          f"inference at bs {list(INFER_BS)}, training at bs {SEARCH_TRAIN_BS}) in "
          f"{time.perf_counter() - t1:.1f} s, mean {mean_profile_s:.3f} s a profile")
    print(f"engine inference forest fitted on {len(fit)} rows of {N_TRAIN_SUB} "
          f"sub-networks, tested on {len(held)} rows of {N_TEST_SUB}: γ MAPE "
          f"{g_err:.2%} (paper, TX2: 1.8%), φ MAPE {p_err:.2%} (paper: 4.4%); "
          f"the grid's Γ forest on the {len(train_rows)} sub-networks at bs "
          f"{SEARCH_TRAIN_BS}: Γ MAPE {gt_err:.2%} (paper: 4.28%)")
    positive("sub-network errors", g_err, p_err, gt_err)
    for r in train_rows:
        inf = [x for x in infer_rows if x["sub"] == r["sub"]]
        print(f"engine sub-network {r['sub']}: Γ(bs {SEARCH_TRAIN_BS}) {r['gamma']:.1f} MB "
              f"Φ {r['phi']:.3f} ms; bs {[x['bs'] for x in inf]}: γ MB "
              f"{[round(x['gamma'], 2) for x in inf]} φ ms {[round(x['phi'], 3) for x in inf]}")

    # 3. the search, under budgets from the measured sub-networks
    path = ROOT / "build" / "repro_torch" / "engine_estimates.json"
    path.unlink(missing_ok=True)          # a fresh cache: every estimate is a miss
    engine = CostEngine(EnsembleBackend([
        ForestBackend(train=cnn["forest"], infer=infer_model), analytical,
        ProfilerBackend(**PROFILE)]), cache=EstimateCache(str(path)))
    bs_kw = dict(train_bs=SEARCH_TRAIN_BS, infer_bs=SEARCH_INFER_BS)
    tiers = {"MAX": Constraints(**bs_kw)}
    tier_notes = {"MAX": "no budget"}
    measured = np.array([[r["gamma"] for r in train_rows],
                         [r["gamma"] for r in infer_rows if r["bs"] == SEARCH_INFER_BS],
                         [r["phi"] for r in infer_rows if r["bs"] == SEARCH_INFER_BS]])
    # The search's first population (its rng draws it first from the seed)
    # as the engine predicts it.  A budget at a quantile of the measurements
    # can lie below every prediction (φ at bs 1 is host time on the card,
    # which the forest does not follow), so each metric's budget is the
    # larger of the quantile of the measurements and that of the predicted
    # first population: then it binds on its own.  Together the three may
    # leave no first candidate feasible, so the budget is raised uniformly,
    # by the least factor that leaves FEASIBLE_FIRST of them feasible, and
    # B's is held inside A's.
    rng = np.random.default_rng(SEARCH["seed"])
    first_w = [sample_subnetwork(base.widths, rng) for _ in range(SEARCH["population"])]
    first = [build_resnet50(widths=w, input_hw=hw).conv_specs() for w in first_w]
    first_fit = np.array([sum(w.values()) for w in first_w], dtype=float)
    pred = np.array([[t.gamma_mb, i.gamma_mb, i.phi_ms] for t, i in zip(
        engine.estimate([CostQuery(spec=n, bs=SEARCH_TRAIN_BS, stage="train") for n in first]),
        engine.estimate([CostQuery(spec=n, bs=SEARCH_INFER_BS, stage="infer") for n in first]))])
    best_first = {"MAX": first_fit.max()}
    cap = np.full(3, np.inf)
    for name, q in (("A", 50), ("B", 25)):
        quant = np.maximum(np.percentile(measured, q, axis=1), np.percentile(pred, q, axis=0))
        for raise_by in np.unique(np.append((pred / quant).max(axis=1), 1.0)):
            budget = np.minimum(cap, quant * max(raise_by, 1.0))
            feasible = (pred <= budget).all(axis=1)
            if feasible.sum() >= FEASIBLE_FIRST:
                break
        else:
            raise AssertionError(f"tier {name}: no budget leaves {FEASIBLE_FIRST} feasible")
        cap = budget
        best_first[name] = first_fit[feasible].max()
        tiers[name] = Constraints(gamma_mb=float(budget[0]), gamma_inf_mb=float(budget[1]),
                                  phi_inf_ms=float(budget[2]), **bs_kw)
        tier_notes[name] = (
            f"Γ <= {budget[0]:.2f} MB, γ <= {budget[1]:.2f} MB, φ <= {budget[2]:.4f} ms; "
            f"the larger of the {'median' if q == 50 else '25th percentile'} of the "
            f"sub-networks' measurements ({', '.join(f'{v:.4g}' for v in np.percentile(measured, q, axis=1))}) "
            f"and of the predicted first population ({', '.join(f'{v:.4g}' for v in np.percentile(pred, q, axis=0))}), "
            f"raised x{max(raise_by, 1.0):.4f}{' and held inside A' if name == 'B' else ''}: "
            f"{int(feasible.sum())} first candidates feasible, the best of fitness "
            f"{best_first[name]:.0f}")
    print("engine first population predicted (%d candidates): Γ %.1f-%.1f MB, γ %.2f-%.2f MB, "
          "φ %.4f-%.4f ms" % (len(pred), *np.ravel(list(zip(pred.min(0), pred.max(0))))))
    results = {}
    for name, tier in tiers.items():
        r = results[name] = evolutionary_search("resnet50", engine, tier, width_mult=wm,
                                                input_hw=hw, **SEARCH)
        print(f"engine search tier {name} ({tier_notes[name]}; train bs {tier.train_bs}, "
              f"infer bs {tier.infer_bs}; population {SEARCH['population']}, iterations "
              f"{SEARCH['iterations']}, seed {SEARCH['seed']}): fitness {r.fitness:.0f} "
              f"(of {sum(base.widths.values())} filters; the best feasible first candidate "
              f"{best_first[name]:.0f}), predicted Γ {r.gamma_mb:.2f} MB "
              f"γ {r.gamma_inf_mb:.2f} MB φ {r.phi_inf_ms:.4f} ms; {r.evaluations} "
              f"evaluations in {r.search_time_s:.3f} s; engine hits {engine.hits} "
              f"misses {engine.misses}")
        positive(f"tier {name} winner", r.fitness, r.gamma_mb, r.gamma_inf_mb, r.phi_inf_ms)
        if any(b < a for a, b in zip(r.history, r.history[1:])):
            raise AssertionError(f"tier {name}: the best fitness fell: {r.history}")
        for budget_v, got in ((tier.gamma_mb, r.gamma_mb), (tier.gamma_inf_mb, r.gamma_inf_mb),
                              (tier.phi_inf_ms, r.phi_inf_ms)):
            if budget_v is not None and got > budget_v:
                raise AssertionError(f"tier {name}: predicted {got} over budget {budget_v}")
        # the search must do better than the best feasible candidate it drew
        if not r.fitness > best_first[name]:
            raise AssertionError(f"tier {name}: winner {r.fitness} no better than the best "
                                 f"feasible first candidate {best_first[name]}")
    mx = results["MAX"]
    for name in ("A", "B"):
        t = tiers[name]
        over = (mx.gamma_mb > t.gamma_mb, mx.gamma_inf_mb > t.gamma_inf_mb,
                mx.phi_inf_ms > t.phi_inf_ms)
        print(f"engine tier {name} binding: the MAX winner's predictions exceed "
              f"Γ {over[0]}, γ {over[1]}, φ {over[2]}")
        if not any(over):
            raise AssertionError(f"tier {name}'s budget does not bind the MAX winner")

    # 4. each winner measured by the engine's chain: model-only queries fall
    # through forest and analytical to the profiler.  Not through the
    # engine's cache: a model-only query keys on the conv geometry, as the
    # reference's does, so the search's own forest estimate of the winner
    # answers it there (ROADMAP queue 3)
    for name, r in results.items():
        tier = tiers[name]
        m = build_resnet50(widths=r.widths, input_hw=hw)
        qs = [CostQuery(model=m, bs=tier.train_bs, stage="train"),
              CostQuery(model=m, bs=tier.infer_bs, stage="infer")]
        est_t, est_i = engine.backend.estimate(qs)
        for e in (est_t, est_i):
            if e.source != "profiler":
                raise AssertionError(f"tier {name} winner answered by {e.source}")
            positive(f"tier {name} winner measured", e.gamma_mb, e.phi_ms)
            expected += len(conv_nodes(m)) * PROFILE_STEPS
        meets = not (
            (tier.gamma_mb is not None and est_t.gamma_mb > tier.gamma_mb)
            or (tier.gamma_inf_mb is not None and est_i.gamma_mb > tier.gamma_inf_mb)
            or (tier.phi_inf_ms is not None and est_i.phi_ms > tier.phi_inf_ms))
        print(f"engine tier {name} winner measured by the engine's chain (source "
              f"{est_t.source}): Γ {est_t.gamma_mb:.2f} MB (predicted {r.gamma_mb:.2f}), "
              f"γ {est_i.gamma_mb:.2f} MB (predicted {r.gamma_inf_mb:.2f}), φ "
              f"{est_i.phi_ms:.4f} ms (predicted {r.phi_inf_ms:.4f}); measurement meets "
              f"the budget: {meets}")

    # 5. tier A again: the same result, every estimate from the cache
    misses = engine.misses
    again = evolutionary_search("resnet50", engine, tiers["A"], width_mult=wm,
                                input_hw=hw, **SEARCH)
    print(f"engine tier A repeated: same result {search_fields(again) == search_fields(results['A'])}, "
          f"new misses {engine.misses - misses}, in {again.search_time_s:.3f} s")
    if search_fields(again) != search_fields(results["A"]) or engine.misses != misses:
        raise AssertionError("the repeated search differs or missed the cache")

    # 6. what the search cost, against profiling every candidate
    for name, r in [*results.items(), ("A (repeat)", again)]:
        naive = r.evaluations * mean_profile_s
        print(f"engine search cost tier {name}: {r.evaluations} evaluations in "
              f"{r.search_time_s:.3f} s ({r.evaluations / r.search_time_s:.0f} evaluations/s); "
              f"profiling each on the card: {naive:.1f} s ({r.evaluations} x "
              f"{mean_profile_s:.3f} s), {naive / r.search_time_s:.0f}x the search")

    torch.cuda.synchronize()
    launches = conv_mm_cuda.launches
    window.report("engine")
    print(f"engine conv_mm launches={launches} (expected {expected} = sum of groups=1 "
          f"convolutions over the profiled topologies x {PROFILE_STEPS} steps); phase "
          f"done in {time.perf_counter() - t0:.1f} s")
    if launches != expected:
        raise AssertionError(f"engine phase conv_mm launches {launches} != {expected}")
    return {"launches": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels.conv_mm import kernel as conv_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.paged_decode import kernel as decode_kernel
    from repro_torch.kernels.ssm_scan import kernel as ssd_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    wrappers = {"paged_decode": (decode_kernel.paged_decode_cuda, decode_kernel.SOURCES),
                "conv_mm": (conv_kernel.conv_mm_cuda, conv_kernel.SOURCES),
                "flash_attention": (flash_kernel.flash_attention_cuda, flash_kernel.SOURCES),
                "ssd_chunk": (ssd_kernel.ssd_chunk_cuda, ssd_kernel.SOURCES)}
    with ThreadPoolExecutor(len(wrappers)) as pool:   # one nvcc each, together
        libs = list(pool.map(lambda w: w[0].load(), wrappers.values()))
    for (name, (wrapper, sources)), lib in zip(wrappers.items(), libs):
        log = Path(lib._name).with_suffix(".log").read_text()
        print(f"build {name} ({', '.join(str(s.relative_to(ROOT)) for s in sources)}): "
              f"nvcc {wrapper.build_seconds:.1f} s; ptxas: {ptxas_summary(log)}")
    print(f"build all kernels ready in {time.perf_counter() - t0:.1f} s")
    for name, lib in zip(wrappers, libs):
        log = Path(lib._name).with_suffix(".log").read_text()
        print(f"build {name} ptxas -v by instantiation: " + "; ".join(
            f"{k} {regs} registers, {spill} bytes spilled" for k, regs, spill in ptxas_kernels(log)))
    # the tensor-core kernels: bf16 paged decode and flash, ssd_chunk (3xTF32)
    for name, lib in zip(wrappers, libs):
        if name == "conv_mm":
            continue
        mma = sass_mma_count(lib._name)
        if mma is None:
            print(f"build {name} SASS tensor-core instructions: not available (no cuobjdump)")
            continue
        print(f"build {name} SASS tensor-core instructions (cuobjdump -sass): "
              f"HGMMA {mma['HGMMA']}, HMMA {mma['HMMA']}")
        if not mma["HGMMA"] + mma["HMMA"] > 0:
            raise AssertionError(f"the {name} library has no tensor-core instruction")
    check_smem_formulas(libs[2], libs[3], libs[1], libs[0])

    t0 = time.perf_counter()
    tuned = tune_phase()
    print(f"tune phase done in {time.perf_counter() - t0:.1f} s")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    timing = kernel_phase(flush)
    conv_timing = conv_kernel_phase(flush)
    flash_timing = flash_kernel_phase(flush, tuned)
    ssd_timing = ssd_kernel_phase(flush, tuned)
    del flush
    torch.cuda.empty_cache()
    served = serve_phase()
    reference_phase()
    cnn = cnn_phase()
    engine = engine_phase(cnn)

    kernels = [{
        "name": "paged_decode",
        "route": "cuda",
        "source": str(decode_kernel.SOURCES[0].relative_to(ROOT)),
        "replaces": REPLACES,
        "launches": served["launches"],
        "max_abs_err": served["max_abs_err"],
        **timing,
    }, {
        "name": "conv_mm",
        "route": "cuda",
        "source": str(conv_kernel.SOURCES[0].relative_to(ROOT)),
        "replaces": CONV_REPLACES,
        "launches": cnn["launches"],
        "engine_launches": engine["launches"],
        "max_abs_err": cnn["max_abs_err"],
        **conv_timing,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": str(flash_kernel.SOURCES[0].relative_to(ROOT)),
        "replaces": FLASH_REPLACES,
        "launches": tuned["launches"]["flash_attention"],
        **flash_timing,
    }, {
        "name": "ssd_chunk",
        "route": "cuda",
        "source": str(ssd_kernel.SOURCES[0].relative_to(ROOT)),
        "replaces": SSD_REPLACES,
        "launches": tuned["launches"]["ssm_scan"],
        **ssd_timing,
    }]
    print(json.dumps({"kernels": kernels}))
    print(f"device {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
