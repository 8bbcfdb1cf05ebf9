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
   (``cuobjdump -sass``) of all four libraries, none of which may be 0
   (``conv_mm``: HGMMA, its ``wgmma`` kernels), and of each f32 flash
   instantiation on its own (HGMMA and HMMA, no spills), of each 3xTF32
   paged decode instantiation (HMMA, no spills) and of each 3xTF32
   ``conv_mm`` instantiation (HGMMA, no spills); hold the shared memory
   the tiling models report against the sources' own formulas, all four
   kernels, ``conv_mm`` at every tile its two tile rules give;
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
   splits, each at the cache_len edges; the 3xTF32 kernel the same way for
   f32 q and pools, f32 q over bf16 pools and bf16 q over f32 pools at rep
   1, 4, 5, 8 and 16, and bf16 at rep 16), the MM convolution on
   every convolution shape of full-width ResNet-50 and on edge cases, f32
   and bf16, and at the kernel bench's bf16 shape (f32 timed against the
   CUDA-core and the 3xTF32 tensor-core bound),
   flash attention at the qwen3-4b prefill shape and edge cases in bf16
   and f32 (decode, a chunk at an offset, head dims 64 and 32, fully
   masked rows against mean(V), also over a ragged last tile), the SSD
   intra-chunk pass at the mamba2-780m shape for every chunk the tuner may
   return, in f32 and with bf16 inputs; time kernel, plain version, a
   library yardstick and the bound with CUDA events (paged decode also at
   each token tile and split, and in f32 and f32 q over bf16 pools at each
   tile and split beside gather + SDPA in f32; flash also in f32, against
   the CUDA-core and the 3xTF32 tensor-core bound);
5. serve — first, while the served weights are drawn on the host and
   before they reach the card (so that which cells run out of memory does
   not depend on them), the campaign
   (``repro_torch.campaign``): a plan over stablelm-1.6b,
   internlm2-1.8b, qwen3-4b and mamba2-780m at full width, train B 1/2/4,
   prefill B 1/2/4/8 and decode B 8/32 at 2048 tokens under the registry's
   ``h100`` spec, half of it by the plan's seeded subsample plus
   the cells the later phases read, and stablelm-1.6b's cells on a 1x2
   mesh; the ``CampaignRunner`` measures every cell on the card (zero-filled inputs,
   CUDA-event Φ, ``max_memory_allocated`` Γ, the ledger traced on meta)
   into a fresh ledger under ``build/repro_torch/campaign/``: every cell
   measured or quarantined (out of memory, or ``MeshSpecError`` for the
   1x2 cells), no kernel launched by a measured step, a second run
   measures nothing, each record with the reference's keys and layout;
   an ``LMForest`` fitted (held-out Γ/Φ MAPE printed), saved and reloaded
   with identical predictions, the cost-ledger constants fitted
   (aggregate and class-wise MAPE); internlm2-1.8b's train estimate
   before and after the fitted constants.  Then full-width qwen3-4b
   (random weights from seed 0, bf16) served
   by ``ContinuousEngine`` over the paged KV pool: 16 greedy requests,
   with the paged-decode launch count read around the run; then the
   kernel is held against its plain version on the served model's own
   inputs, and a reduced qwen3-4b on the card is held against the same
   model on the CPU (the port's plain path); launches the tuner makes
   inside this window (a prefill shape it has not seen) are counted
   apart and printed; then, on the same parameters, the admit phase:
   a ``CostEngine(AnalyticalBackend(lm_device=<this card's spec>))``
   estimates qwen3-4b ``infer`` (bs 8, seq 2048) and internlm2-1.8b
   ``train`` (bs 4, seq 2048) by tracing each step on meta tensors: Γ, Φ,
   energy, the ledger's class sums (which must re-sum to its aggregates),
   matmul FLOPs within [0.5, 3]x ``model_flops_for_cell``, the roofline
   report; a repeated query must be a cache hit with no trace, and a trace
   must launch no kernel and allocate nothing on the card.  Then
   ``ContinuousEngine`` serves the 16 requests gated by the
   ``SLOScheduler`` at a memory budget between the estimates of 4 and 5
   concurrent requests, plus two planted requests that must be refused
   (one past the context window, one whose per-token SLO fails even
   alone): 16 finished, ``lost == 0``, ``defer_backoffs > 0``, at most 4
   concurrent, paged-decode launches ``decode_steps x 36`` and the kernel
   within 1e-2 of its plain version on the gated pool, throughput beside
   the ungated run's; injected backend faults step the failover chain
   down to static degraded mode (at most 2 concurrent while degraded,
   every request finishes); the training launcher refuses full-width
   internlm2-1.8b at ``--memory-budget-gb 20`` before drawing a
   parameter; then, on the same parameters, the 16 requests served under
   ``SLOScheduler`` priced by the campaign's forest (``register_lm_forest``), at a
   budget between the forest's Γ at 4 and 5 requests: ``lost == 0``, at
   most k running, every admission query answered by the forest with no
   trace, launch or allocation, paged-decode launches ``decode_steps x
   36`` and the kernel within 1e-2 of its plain version; the launcher
   with ``--lm-forest`` refuses internlm2-1.8b at half the forest's Γ
   before drawing a parameter;
6. layers — the non-dense layer plans (MoE, SSD, cross-attention): every
   registry architecture at ``reduced()`` in f32 (TF32 off, tuning pinned)
   on the card against the CPU, ``forward`` logits and ``prefill`` + one
   ``decode_step``, and, for each pure self-attention stack at head_dim
   64, a chunk and two decode steps over the paged pool (the 3xTF32
   kernel's launches counted); full-width mamba2-780m (48 layers, bf16, seed 0)
   served by the lockstep ``ServeEngine`` over 8 ragged prompts of
   256-1024 tokens, 64 greedy tokens each, with the SSD chunk tuned at the
   prefill's shape (the SSD kernel timed by the tuner: four launches per
   timed config, none on the main path), prefill ms, TPOT and tokens/s,
   and decode against forward within the reference's rel 0.05;
   full-width qwen3-moe-30b-a3b with its depth cut to 4 of 48 layers
   served by ``ContinuousEngine`` over the paged pool (16 greedy requests,
   paged-decode launches == decode steps x 4, the kernel held against its
   plain version on the served inputs), the tuner's (groups,
   capacity_factor) and the share of (token, expert) pairs one prefill
   drops; full-width whisper-tiny, a prefill over its 1500 frames and
   decode steps with the encoder's memory, decode against forward;
7. train — the LM training path: one ``loss_fn`` + backward of a reduced
   internlm2-1.8b in f32 on the card against the CPU (TF32 off), every
   gradient leaf; ``warm_autotune(stages=("train",))`` for full-width
   internlm2-1.8b at batch 4 over 2048 tokens on the tune phase's tuner,
   which times the flash kernel at that new shape (four launches per
   timed config, none on the main path), then the kernel against its
   plain version there and timed; ``Trainer`` trains full-width
   internlm2-1.8b (random weights from seed 0, bf16, AdamW) for 6 steps:
   per-step time, loss, tokens/s, MFU, the state's memory against its
   reckoning, the peak, flash attention's main-path launches (0: training
   attention is ``blocked_attention``, as in the reference), the loss with
   ``seq_chunk=512`` beside the unchunked one and a traced step; then the
   trained state at the reference's training sequence length, batch 2
   over 4096 tokens (timed steps, the peak and a traced step); a reduced
   checkpoint saved on the card and restored bit for bit;
8. cnn — the paper's toolflow: one training step of a reduced ResNet-50
   on the card against the CPU; then full-width ResNet-50 (32x32,
   CIFAR-100) pruned, profiled for Γ and Φ over the paper's train levels
   and the default test levels at five batch sizes (``collect_grid``),
   with the convolution kernel's launch count read around the grid, then
   the kernel held against its plain version at every (batch size,
   convolution shape) the grid gave it; the predictor fitted on the
   train points and its Γ/Φ error printed for each test grid;
9. engine — paper §6.4 through the cost engine: an analytical spec of
   this card calibrated on the cnn phase's train grid (every workload
   from the cnn phase's cache, none profiled) and the tuner's timed
   winners; 16 full-width ResNet-50 sub-networks (seeds 2000 + i)
   profiled for inference at bs 1, 2, 4, 8 and for training at bs 16,
   the inference forest fitted on 10 and tested on 6; the evolutionary
   search (population 32, 40 iterations) through a ``CostEngine`` over
   forest → calibrated analytical → profiler, under no budget and under
   budgets at the median and the lower quartile of the sub-networks'
   measurements (the Table 2 runner's ``budget_tiers``); each winner
   measured through the engine (model-only queries, answered by the
   profiler); tier A repeated (same result, no new miss); the convolution
   kernel's launch count read around the phase;
10. bench — two paper runners of ``repro_torch.bench`` at full width: the
   §6.2.1 DNNMem comparison over the cnn phase's cache (0 profiled, 0
   convolution kernel launches) and the §6.2 strategy variation on a fresh
   cache (the MobileNetV2 train grid and 8 strategies profiled, the kernel's
   launches held to the expected count), each gated on the datapoints and
   launches its runner reports; their CSV lines; then the kernel held
   against its plain version at every (batch size, convolution shape) the
   strategies run gave it and at every one the full paper set
   (``python -m repro_torch.bench.run``) gives it, seven families;
11. benches — the auto-sharding planner and the beyond-paper benches
   (``repro_torch.planner``, ``repro_torch.bench``): (a) full-width
   internlm2-1.8b, train B 4 x S 2048, planned over 1, 2, 4 and 8 devices
   through ``LayoutPlanner(CostEngine(EnsembleBackend([AnalyticalBackend(
   lm_device=<this card>)])))`` — one meta trace for the base, every later
   query a cache hit, no kernel launched and nothing allocated, 1x1x1's Φ
   the base, 1x8x1 refused for batch divisibility, each table printed and
   1x1x1's Φ and Γ beside the train phase's step and peak; (b)
   ``engine_bench.planner_bench()`` over 256 ``tpu_v5e`` devices (0
   traces); (c) the training launcher with ``--auto-mesh 4 --n-micro 8``
   on the h100 spec: the plan, the one-card line and one step, whose loss
   must match the train phase's first loss; (d) ``serve_bench`` at full
   width: internlm2-1.8b drawn once and served by ``run`` (lockstep
   against continuous, ``SERVE_RUN_PASSES`` passes, each printed; its two
   host-clock conditions read the median pass), ``run_chunked`` (one
   measured pass a mode, ``SERVE_CHUNK_REPEATS``: its gates are step
   counts) and ``run_chaos``, paged-decode launches held to decode steps x 24 around
   each, the reference's ``check_thresholds`` conditions, the kernel against its plain version
   on the served pool; (e) ``kernel_bench.run()`` (the tuner's model rows,
   the plain versions timed, and each Hopper kernel's ``card_us`` row at
   the bench's shapes against its plain version and its bound) and
   ``engine_bench`` (``run``, ledger parity, calibration on the repo's
   fixture, the reduced smoke campaign measured on the card into a fresh
   ledger); each sub-phase's seconds;
12. dist — sharded execution (``repro_torch.launch.{mesh,lowering,dryrun}``,
   ``repro_torch.distributed``): (a) the dry-run, in a child process
   started before the train phase and collected here (host work on meta
   tensors under a ``fake`` process group, beside the train phase, whose
   timed steps are bound by the card): full-width
   internlm2-1.8b, qwen3-4b (train_4k, prefill_32k, decode_32k) and
   qwen3-moe-30b-a3b (train_4k, all 48 layers) on the production 16x16
   mesh, internlm2-1.8b train_4k on 2x16x16 and on 1x1, and the train
   cell (B 4 x S 2048) on the planner's 1x2x4 layout, priced on this
   card's spec into a fresh ledger under ``build/repro_torch/dist/``;
   every cell again (``DONE``), the roofline table; gated on collective
   bytes > 0 on every multi-device cell and 0 on 1x1, all-to-all bytes > 0
   on the MoE cell, the class breakdown re-summing to the aggregates, no
   kernel launched and nothing allocated on the card; (b) one real rank:
   an ``nccl`` group of world size 1, full-width internlm2-1.8b (the
   benches phase's seed-0 draw) trained one step through
   ``Trainer(mesh=make_mesh((1, 1)), state_shardings=...)``, its first
   loss within 1e-6 of the train phase's; the launcher's ``--auto-mesh 1``
   trains unsharded; (c) rank 0 of the planner's 1x2x4 layout of the
   train cell run for real under a ``fake`` group of 8 on the card
   (zero-filled, collectives that move nothing): its Γ and step time
   beside the per-device numbers of the benches phase's plan and of the
   dry-run, gated on the steps completing with Γ > 0 and every local
   shard owning no more storage than its own; (d) ``engine_bench.collective_calibration``
   on two ``gloo`` CPU ranks (beside (a)-(c)) and
   ``check_thresholds.evaluate`` over the benches phase's results and
   the calibration's: every condition printed, a ``FAIL`` fails the run;
13. a ``{"kernels": [...]}`` JSON line (``conv_mm`` with the ResNet-50
   forward's f32 sums as its unprefixed numbers, ``bound_ms`` the 3xTF32
   one and ``cuda_core_bound_ms`` the f32 work on the CUDA cores, the bf16
   ones as ``bf16_forward_*``, and the bench shape's bf16 ``bf16_bench_*``; the
   flash entry with the f32 prefill's ``f32_ms``, ``f32_library_ms`` and
   ``f32_bound_ms`` and the train
   phase's ``train_*`` numbers, paged decode with the 3xTF32 kernel's
   ``tf32_*`` errors, its f32 (``f32_*``) and f32-q-over-bf16
   (``f32q_bf16pool_*``) serving-shape numbers, the reference and layers
   phases' launches, the layers phase's
   ``moe_*``, the admit phase's ``admit_*``, the campaign phase's
   ``campaign_*`` and the benches phase's ``serve_bench_*`` numbers, SSD
   with its ``serve_launches``, each with ``kernel_bench_launches`` and
   ``kernel_bench_ms`` from its ``card_us`` row), the card line again, and
   last ``{"ok": true, "device": {...}}``.

Without CUDA, or without the rest of the repository beside it, it fails
before printing any result.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
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

TF32_FLOPS = 495e12          # tensor cores; 3xTF32 does three TF32 products an f32 one

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
    """``kernel_bench.card_time_ms``, the one timer behind the kernel
    table: the median of ``reps`` calls after ``warmup``, by CUDA events,
    with L2 flushed before every call (in a decode step each layer's pool
    is cold)."""
    from repro_torch.bench.kernel_bench import card_time_ms

    return card_time_ms(fn, flush, reps=reps, warmup=warmup)


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
        # every tile the dtype's rule gives, over the GEMMs of ResNet-50 at
        # bs 1-256 and beyond
        tiles = {conv_tiling.tile_for(M, O, dtype)
                 for M in (1, 64, 2048, 8192, 16384, 16896, 131072, 2**22)
                 for O in (1, 8, 64, 65, 128, 256, 2048)}
        for bm, bn in sorted(tiles):
            smem = conv_lib.conv_mm_smem_bytes(bm, bn, flag)
            if smem != conv_tiling.smem_bytes(bm, bn, dtype) or smem > 232448:
                raise AssertionError(f"conv_mm smem formula differs at tile "
                                     f"{bm}x{bn} {dtype} (or exceeds 232448 bytes)")
    for l in (16, 32, 64, 96, 100, 128, 256):
        for N, P in ((128, 64), (32, 32), (16, 8), (100, 50)):
            if ssd_lib.ssd_chunk_smem_bytes(l, N, P) != ssm_tiling.smem_bytes(l, N, P):
                raise AssertionError(f"ssd smem formula differs at l={l} N={N} P={P}")
    for kv_dt, kv_flag in (("bfloat16", 1), ("float32", 0)):
        for Dh in (64, 128):
            for bkv in (1, 8, 12, 16, 32, 48, 64, 100, 128, 256, 512):
                if (decode_lib.paged_decode_smem_bytes(Dh, bkv, kv_flag)
                        != pd_tiling.smem_bytes(Dh, bkv, kv_dt)):
                    raise AssertionError(f"paged_decode smem formula differs at Dh={Dh} "
                                         f"block_kv={bkv} pools {kv_dt}")
    print("build shared-memory formulas of flash_attention, conv_mm, ssd_chunk and "
          "paged_decode: the CUDA sources and the tiling models agree")


def kernel_name(mangled: str) -> str:
    """``name<template arguments>`` of a mangled kernel symbol: integer and
    bool literals as numbers, ``float`` and named types by name (a repeated
    named type, mangled as a substitution, as the last one named)."""
    for m in re.finditer(r"\d+", mangled):
        name = mangled[m.end():m.end() + int(m.group())]
        if name.endswith("_kernel"):
            rest, args, named, i = mangled[m.end() + len(name):], [], [], 1
            while rest[:1] == "I" and i < len(rest) and rest[i] != "E":
                if rest[i] == "L":                       # a literal: L<type><value>E
                    end = rest.index("E", i)
                    args.append(rest[i + 2:end])
                    i = end + 1
                elif rest[i].isdigit():                  # a named type: <length><name>
                    n = re.match(r"\d+", rest[i:]).group()
                    args.append(rest[i + len(n):i + len(n) + int(n)])
                    named.append(args[-1])
                    i += len(n) + int(n)
                elif rest[i] == "S":                     # a repeated named type: S<id>_
                    args.append(named[-1] if named else "?")
                    i = rest.index("_", i) + 1
                else:                                    # a builtin type
                    args.append({"f": "float", "i": "int", "b": "bool"}.get(rest[i], rest[i]))
                    i += 1
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


def sass_mma_count(lib_path: str, by_function: bool = False) -> dict | None:
    """Tensor-core instructions (HGMMA, HMMA) in a library's SASS, from
    ``cuobjdump -sass``: ``{op: n}`` over the library, or with
    ``by_function`` ``{kernel instantiation: {op: n}}``; None where the
    tool is not available."""
    import os
    import shutil

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.isfile(tool) else shutil.which("cuobjdump")
    if not tool:
        return None
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True)
    if proc.returncode != 0:
        return None
    ops = ("HGMMA", "HMMA")
    counts, name = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :")[1].strip())
            counts.setdefault(name, dict.fromkeys(ops, 0))
            continue
        words = line.split()
        for op in ops:
            if name and any(w.startswith(op + ".") or w == op for w in words):
                counts[name][op] += 1
    if by_function:
        return counts
    return {op: sum(c[op] for c in counts.values()) for op in ops}


# the f32 convolution kernel (3xTF32 on wgmma): both tiles its rule gives
# (64 x 64, 128 x 128) x both A gathers
CONV_TF32_INSTANTIATIONS = {f"conv_mm_tf32_wgmma_kernel<{b}, {b}, {vec_a}>"
                            for b in (64, 128) for vec_a in (0, 1)}
FLASH_F32_INSTANTIATIONS = {f"flash_attention_f32_kernel<{dh}, {bn}>"
                            for dh in (32, 64, 128) for bn in (32, 64)}
# the 3xTF32 paged decode kernel: (q, pools) x head dim x every tile whose ring fits
DECODE_TF32_INSTANTIATIONS = {
    f"paged_decode_tf32_kernel<{qt}, {kt}, {dh}, {tk}>"
    for qt in ("float", "__nv_bfloat16") for kt, elt in (("float", 4), ("__nv_bfloat16", 2))
    for dh in (64, 128) for tk in (16, 32, 64, 128, 256) if 3 * 2 * tk * dh * elt <= 232448}


def check_build(label: str, lib_path: str, log: str, expected: set, ops: tuple) -> None:
    """Every instantiation in ``expected`` has each tensor-core instruction
    of ``ops`` in its own SASS (the library-wide count cannot show it where
    other kernels of the library have them) and spills nothing."""
    sass = sass_mma_count(lib_path, by_function=True)
    if sass is None:
        raise AssertionError(f"cuobjdump is needed to show the {label} kernel's "
                             f"tensor-core instructions")
    prefix = next(iter(expected)).split("<")[0]
    got = {k: v for k, v in sass.items() if k.startswith(prefix)}
    spills = {k: s for k, _, s in ptxas_kernels(log) if k.startswith(prefix)}
    print(f"build {label} instantiations (SASS, ptxas): " + "; ".join(
        f"{k} " + " ".join(f"{op} {got[k][op]}" for op in ops) + f", {spills.get(k)} bytes spilled"
        for k in sorted(got)))
    if set(got) != expected or set(spills) != expected:
        raise AssertionError(f"{label} instantiations {sorted(got)} / {sorted(spills)}, "
                             f"expected {sorted(expected)}")
    bad = [k for k in got if not all(got[k][op] > 0 for op in ops) or spills[k] != 0]
    if bad:
        raise AssertionError(f"{label} instantiations without {' and '.join(ops)}, or with "
                             f"spills: {bad}")


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
    """Yardstick only (never used by the port): gather the logical view (in
    q's type), then one ``scaled_dot_product_attention`` call with the rep
    query heads of each KV head as its query rows."""
    import torch
    import torch.nn.functional as F

    B, H, Dh = q.shape
    Hkv = kp.shape[2]
    k = kp[bt.long()].reshape(B, -1, Hkv, Dh).transpose(1, 2).to(q.dtype)
    v = vp[bt.long()].reshape(B, -1, Hkv, Dh).transpose(1, 2).to(q.dtype)
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


def decode_tiles(Dh, H, Hkv, kv_dtype) -> list[int]:
    """The token tiles the tuner may return at the serving table (its
    candidates whose ring fits, in the pools' type)."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.paged_decode import tiling as pd_tiling

    shape = pd_tiling.shape_key(DECODE["B"], H, Hkv, Dh, DECODE["NB"], DECODE["bs"], kv_dtype)
    return sorted({c["block_kv"] for c in pd_tiling.candidates(shape)
                   if autotune.smem_ok(pd_tiling.cost(shape, c))})


# (q, pools) of the 3xTF32 kernel: every pair but bf16 q and pools at rep <= 8
TF32_PAIRS = (("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32"),
              ("bfloat16", "bfloat16"))
# (H, Hkv): rep 1, 4, 5, 8 and 16
DECODE_HEADS = ((32, 32), (32, 8), (40, 8), (32, 4), (32, 2))


def decode_timing(label, args, flush) -> dict:
    """The kernel at the serving shape at each token tile and split, beside
    its plain version, gather + SDPA in q's type (the pools cast to it) and
    the bound; the best config's numbers."""
    from repro_torch.kernels.paged_decode.kernel import paged_decode_cuda
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref

    q, kp = args[0], args[1]
    want = paged_decode_ref(*args)
    lib_err = float((library_decode(*args).float() - want.float()).abs().max())
    times = {(bkv, ns): time_ms(lambda: paged_decode_cuda(*args, block_kv=bkv, n_splits=ns),
                                flush)
             for bkv in decode_tiles(q.shape[2], q.shape[1], kp.shape[2], kp.dtype)
             for ns in (1, 2, 4, 8)}
    best = min(times, key=times.get)
    plain_ms = time_ms(lambda: paged_decode_ref(*args), flush)
    library_ms = time_ms(lambda: library_decode(*args), flush)
    bound_ms, bound_by = bound(q, kp, args[4])
    live = int((args[4].long() + 1).sum())
    for bkv in sorted({c[0] for c in times}):
        print(f"timing paged_decode {label} B=8 H=32 Hkv=8 Dh=128 bs=256 NB=8 "
              f"live_tokens={live}, block_kv={bkv}, by n_splits: " + ", ".join(
                  f"{ns}: {times[bkv, ns]:.4f} ms" for ns in (1, 2, 4, 8)))
    print(f"timing paged_decode {label}: best block_kv {best[0]} n_splits {best[1]} "
          f"{times[best]:.4f} ms; plain {plain_ms:.4f} ms, gather+sdpa {q.dtype} "
          f"{library_ms:.4f} ms (max_abs_err vs plain {lib_err:.3e}), bound {bound_ms:.4f} ms "
          f"({bound_by}) -> {bound_ms / times[best]:.1%} of bound")
    return {"ms": times[best], "block_kv": best[0], "n_splits": best[1], "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def kernel_phase(flush) -> dict:
    import torch

    from repro_torch.kernels import autotune
    from repro_torch.kernels.paged_decode import tiling as pd_tiling
    from repro_torch.kernels.paged_decode.kernel import paged_decode_cuda
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref

    bs, NB = DECODE["bs"], DECODE["NB"]
    edges = [0, bs - 1, bs, 2 * bs - 1, 3 * bs, 5 * bs + 17, NB * bs - 1, 700]
    # bf16 q and pools at rep <= 8 run the tensor-core kernel: every token
    # tile the tuner may return (the candidates whose ring fits), every split
    for Dh in (128, 64):
        for H, Hkv in DECODE_HEADS[:4]:
            tiles = decode_tiles(Dh, H, Hkv, "bfloat16")
            args = decode_case(torch.bfloat16, Dh, edges, H=H, Hkv=Hkv)
            want = paged_decode_ref(*args)
            err = max(decode_check(f"Dh={Dh} H={H} Hkv={Hkv} bf16", args, want,
                                   block_kv=bkv, n_splits=ns)
                      for bkv in tiles for ns in (1, 2, 4, 8))
            print(f"kernel paged_decode Dh={Dh} bfloat16 H={H} Hkv={Hkv} (rep {H // Hkv}) "
                  f"at block_kv {tiles} x n_splits [1, 2, 4, 8]: max_abs_err={err:.3e} "
                  f"(tol {TOL['bfloat16']})")
    # every other pair, and bf16 at rep 16: the 3xTF32 kernel, at every tile
    # whose ring fits in the pools' type and every split
    tf32_err = {}
    for q_dt, kv_dt in TF32_PAIRS:
        for Dh in (128, 64):
            for H, Hkv in DECODE_HEADS[4:] if q_dt == kv_dt == "bfloat16" else DECODE_HEADS:
                tiles = decode_tiles(Dh, H, Hkv, kv_dt)
                q, *rest = decode_case(getattr(torch, kv_dt), Dh, edges, H=H, Hkv=Hkv)
                args = (q.to(getattr(torch, q_dt)), *rest)
                want = paged_decode_ref(*args)
                err = max(decode_check(f"Dh={Dh} H={H} Hkv={Hkv} q {q_dt} pools {kv_dt}",
                                       args, want, block_kv=bkv, n_splits=ns)
                          for bkv in tiles for ns in (1, 2, 4, 8))
                tf32_err[q_dt] = max(tf32_err.get(q_dt, 0.0), err)
                print(f"kernel paged_decode (3xTF32) Dh={Dh} q {q_dt} pools {kv_dt} H={H} "
                      f"Hkv={Hkv} (rep {H // Hkv}) at block_kv {tiles} x n_splits "
                      f"[1, 2, 4, 8]: max_abs_err={err:.3e} (tol {TOL[q_dt]})")

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
    for bkv in decode_tiles(DECODE["Dh"], DECODE["H"], DECODE["Hkv"], "bfloat16"):
        splits = {ns: time_ms(lambda: paged_decode_cuda(*args, block_kv=bkv, n_splits=ns),
                              flush) for ns in (1, 2, 4, 8)}
        print(f"timing paged_decode same inputs, block_kv={bkv}, by n_splits: " + ", ".join(
            f"{ns}: {t:.4f} ms" for ns, t in splits.items()))

    # the 3xTF32 kernel at the same shape and fills (no tuner: its launches
    # would count in the serve window): f32 q and pools, and f32 q over a
    # bf16 pool (the f32 models' decode)
    q, *rest = decode_case(torch.float32, DECODE["Dh"], fills.tolist(), seed=1)
    f32 = decode_timing("f32", (q, *rest), flush)
    q, *rest = decode_case(torch.bfloat16, DECODE["Dh"], fills.tolist(), seed=1)
    mixed = decode_timing("f32 q over bf16 pools", (q.float(), *rest), flush)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tf32_max_abs_err": tf32_err["float32"],
            "tf32_bf16_max_abs_err": tf32_err["bfloat16"],
            **{f"f32_{k}": v for k, v in f32.items()},
            **{f"f32q_bf16pool_{k}": v for k, v in mixed.items()}}


def host_draw(cfg):
    """Start ``init_params(cfg, 0)`` on the host in a thread and return a
    future of (the CPU model, seconds).  numpy's generators and the copies
    into the model release the interpreter lock, so the draw runs beside
    the card's work on another core; the caller moves the result to the
    card with ``.to("cuda")`` (the same values as a draw onto the card)."""
    from repro_torch.models import transformer as T

    def draw():
        t0 = time.perf_counter()
        model = T.init_params(cfg, 0, device="cpu")
        return model, time.perf_counter() - t0

    pool = ThreadPoolExecutor(1)
    future = pool.submit(draw)
    pool.shutdown(wait=False)
    return future


def serve_phase() -> dict:
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.paged_decode import ops
    from repro_torch.kernels.paged_decode.kernel import paged_decode_cuda
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref
    from repro_torch.serve import ContinuousConfig, ContinuousEngine, Request

    cfg = get_config("qwen3-4b")
    # drawn on the host while the campaign runs, on the card only after it
    # (so that which cells run out of memory does not depend on them)
    drawing = host_draw(cfg)
    campaign = campaign_phase()
    t0 = time.perf_counter()
    params, draw_s = drawing.result()
    params = params.to("cuda")
    torch.cuda.synchronize()
    print(f"serve init_params(qwen3-4b, seed=0): {cfg.param_count() / 1e9:.3f}e9 "
          f"parameters drawn with numpy on the host in {draw_s:.1f} s beside the "
          f"campaign, on the card {time.perf_counter() - t0:.1f} s after it")
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
    ungated = {"streams": {tuple(r.prompt.tolist()): list(r.tokens) for r in engine.finished},
               "metrics": m, "wall": wall,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del engine, last, q, kp, vp, got, want
    decode_breakdown(cfg, params, scfg, prompts)
    t0 = time.perf_counter()
    admitted = admit_phase(cfg, params, scfg, prompts, ungated)
    print(f"admit phase done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gated = campaign_serve(cfg, params, scfg, prompts, ungated, campaign["forest"])
    campaign_launcher(campaign["path"], campaign["forest"])
    print(f"campaign serve and launcher done in {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": err, "admit": admitted,
            "campaign": {**gated, "estimates": campaign["estimates"]}}


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
    # either tensor-core kernel (bf16, or 3xTF32), and the split merge
    paged = sum(t for k, t in by_kernel.items() if re.search(r"paged_decode_\w*kernel", k))
    merge = sum(t for k, t in by_kernel.items() if "combine_splits_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"decode step ({cfg.name}), 8 slots at ~256-280 tokens of context: host wall "
          f"{wall_ms:.2f} ms/step, device kernel time {dev_ms:.2f} ms/step "
          f"(device idle {1 - dev_ms / wall_ms:.1%}), paged_decode "
          f"{paged:.3f} ms/step ({paged / dev_ms:.1%} of kernel time) + its split "
          f"merge {merge:.3f} ms/step; the "
          f"n_splits lookup (a tuner memo hit) {lookup_us:.1f} us on the host, "
          f"{lookup_us * cfg.n_layers / 1e3:.3f} ms/step over {cfg.n_layers} layers")
    print(f"decode step ({cfg.name}) top kernels (ms/step): " + "; ".join(
        f"{k[:60]} {t:.3f}" for k, t in top))


# ---------------------------------------------------------------------------
# Admission: the cost engine's LM estimate and SLO serve admission
# ---------------------------------------------------------------------------

ADMIT_QUERIES = (("qwen3-4b", "infer", 8, 2048), ("internlm2-1.8b", "train", 4, 2048))
ADMIT_FLOPS_RATIO = (0.5, 3.0)   # ledger matmul flops / model_flops_for_cell
ADMIT_ENERGY_REL = 1e-9
ADMIT_DEGRADED_SLOTS = 2


def all_kernels() -> dict:
    from repro_torch.kernels.conv_mm.kernel import conv_mm_cuda

    return {**tuned_kernels(), "conv_mm": conv_mm_cuda}


def kernel_counts() -> dict:
    return {n: (k.launches, getattr(k, "tuner_launches", 0))
            for n, k in all_kernels().items()}


def admit_estimates(engine, backend, spec) -> dict:
    """Part 1: the two estimates on this card's spec, traced on meta
    tensors; gates: class sums re-sum to the aggregates, matmul flops
    within ``ADMIT_FLOPS_RATIO`` of ``model_flops_for_cell``, a repeated
    query answered from the cache with no trace, and no kernel launch and
    no allocation on the card during a trace."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.core.roofline import model_flops_for_cell, roofline_from_cost
    from repro_torch.engine import CostQuery

    out = {}
    for arch, stage, bs, seq in ADMIT_QUERIES:
        q = CostQuery(arch=arch, bs=bs, seq=seq, stage=stage, reduced=False)
        cfg = get_config(arch)
        torch.cuda.synchronize()
        counts, alloc = kernel_counts(), torch.cuda.memory_allocated()
        est = engine.estimate_one(q)
        torch.cuda.synchronize()
        if kernel_counts() != counts or torch.cuda.memory_allocated() != alloc:
            raise AssertionError(f"admit {arch} {stage}: the trace launched or allocated: "
                                 f"{counts} -> {kernel_counts()}, {alloc} -> "
                                 f"{torch.cuda.memory_allocated()} bytes")
        _, cost, mem = backend.last_trace
        d = est.detail
        classes = d["cost_classes"]
        for key in ("flops", "hbm_bytes"):
            if sum(c[key] for c in classes.values()) != d[key]:
                raise AssertionError(f"admit {arch}: {key} class sums do not re-sum")
        e_dyn = sum(c["energy_j"] for c in classes.values())   # envelope pricing
        if not abs(e_dyn - (est.energy_j - d["energy_static_j"])) <= ADMIT_ENERGY_REL * e_dyn:
            raise AssertionError(f"admit {arch}: energy class sums {e_dyn} do not re-sum")
        kind = "train" if stage == "train" else "prefill"
        mf = model_flops_for_cell(cfg, ShapeSpec("admit", seq, bs, kind))
        report = roofline_from_cost(cost, arch=arch, shape=f"{kind}_b{bs}_s{seq}",
                                    mesh_desc="1", n_devices=1, model_flops_total=mf,
                                    hw=spec, plan_bytes=est.gamma_mb * 1e6,
                                    compile_s=d["compile_s"])
        ratio = classes["matmul"]["flops"] / mf
        traces = backend.traces
        hits = engine.hits
        again = engine.estimate_one(q)
        print(f"admit estimate {arch} {stage} bs={bs} seq={seq} on {spec.name}: "
              f"Γ {est.gamma_mb / 1e3:.3f} GB (arg {mem['arg'] / 1e9:.3f}, temp "
              f"{mem['temp'] / 1e9:.3f}, out {mem['out'] / 1e9:.3f}), Φ {est.phi_ms:.2f} ms, "
              f"energy {est.energy_j:.3f} J, flops {d['flops']:.4e}, hbm bytes "
              f"{d['hbm_bytes']:.4e}, dominant {d['dominant']}, {len(cost.ledger)} records, "
              f"trace {d['compile_s']:.2f} s, useful_ratio {report.useful_ratio:.3f}, "
              f"matmul flops / model flops {ratio:.3f} (gate {ADMIT_FLOPS_RATIO})")
        print(f"admit estimate {arch} {stage} classes: " + "; ".join(
            f"{c} flops {v['flops']:.4e} bytes {v['hbm_bytes']:.4e} energy "
            f"{v['energy_j']:.4f} J n={v['count']}" for c, v in classes.items()))
        print(f"admit estimate {arch} {stage} roofline: {report.summary()}")
        if not ADMIT_FLOPS_RATIO[0] <= ratio <= ADMIT_FLOPS_RATIO[1]:
            raise AssertionError(f"admit {arch}: matmul flops ratio {ratio}")
        if backend.traces != traces or engine.hits != hits + 1 or \
                again.gamma_mb != est.gamma_mb:
            raise AssertionError(f"admit {arch}: the repeat was not a cache hit "
                                 f"without a trace")
        out[(arch, stage)] = est
    return out


def admit_serve(cfg, params, scfg, prompts, ungated, engine, backend) -> dict:
    """Part 2: ``ContinuousEngine`` gated by the ``SLOScheduler`` at a
    budget between the estimates of 4 and 5 requests, plus two planted
    refusals; part 3 (failover) in :func:`admit_failover`."""
    import dataclasses

    import torch

    from repro_torch.engine import CostQuery
    from repro_torch.kernels.paged_decode import ops
    from repro_torch.kernels.paged_decode.kernel import paged_decode_cuda
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref
    from repro_torch.serve import ContinuousEngine, PlacementRefused, Request

    margin = scfg.safety_margin
    gamma = {bs: engine.estimate_one(CostQuery(arch=cfg.name, bs=bs, seq=scfg.max_len,
                                               stage="infer", reduced=False)).gamma_mb
             for bs in (1, 4, 5)}
    phi1 = engine.estimate_one(CostQuery(arch=cfg.name, bs=1, seq=scfg.max_len,
                                         stage="infer", reduced=False)).phi_ms
    budget = ((1 + margin) * gamma[4] + (1 + margin) * gamma[5]) / 2
    slo_ms = 0.5 * phi1 / scfg.max_len * (1 + margin)
    gated = dataclasses.replace(scfg, gamma_budget_mb=budget)
    head = prompts[0][:scfg.max_len // 2]     # needs 24 tokens more than the window
    big = Request(head.copy(), max_new_tokens=scfg.max_len - len(head) + 24)
    slow = Request(prompts[1][:64].copy(), max_new_tokens=32, slo_ms=slo_ms)
    requests = [Request(p, max_new_tokens=32) for p in prompts]
    queue = requests[:1] + [big, slow] + requests[1:]
    print(f"admit serve: Γ(bs 1/4/5, max_len {scfg.max_len}) {gamma[1]:.1f} / "
          f"{gamma[4]:.1f} / {gamma[5]:.1f} MB, margin {margin}: gamma_budget_mb "
          f"{budget:.1f}; Φ(bs 1) {phi1:.3f} ms, planted slo_ms {slo_ms:.6f}")

    ce = ContinuousEngine(cfg, params, gated, cost_engine=engine)
    last = {}
    launch = ops.paged_decode_cuda

    def keep_last(*args, **kw):
        last["args"], last["kw"] = args, kw
        return launch(*args, **kw)

    traces, trace_s = backend.traces, backend.trace_seconds
    torch.cuda.synchronize()
    ops.paged_decode_cuda = keep_last
    paged_decode_cuda.launches = 0
    most = 0
    t0 = time.perf_counter()
    try:
        for r in queue:
            ce.submit(r)
        while not ce.idle:
            ce.step()
            most = max(most, ce.n_running)
        torch.cuda.synchronize()
    finally:
        ops.paged_decode_cuda = launch
    wall = time.perf_counter() - t0
    launches = paged_decode_cuda.launches
    m = ce.metrics()
    refused = {r.rid: str(r.refusal) for r in ce.refused}
    print(f"admit serve qwen3-4b gated: {m['finished']} finished, {m['refused']} refused, "
          f"lost={m['lost']}, defer_backoffs={m['defer_backoffs']}, largest concurrent "
          f"{most}, decode_steps={m['decode_steps']}, paged_decode launches={launches}; "
          f"pricing: {backend.traces - traces} traces in "
          f"{backend.trace_seconds - trace_s:.2f} s, engine hits {engine.hits} misses "
          f"{engine.misses}")
    for rid, msg in refused.items():
        print(f"admit serve refusal {rid}: {msg}")
    if not (m["finished"] == len(requests) and m["lost"] == 0 and m["refused"] == 2
            and {big.rid, slow.rid} == set(refused)):
        raise AssertionError(f"admit serve: not 16 finished and the 2 planted refused: {m}")
    if not ("max_len" in str(big.refusal) and "SLO" in str(slow.refusal)
            and isinstance(slow.refusal, PlacementRefused)
            and "cost_classes" in slow.refusal.info):
        raise AssertionError("admit serve: the planted refusals lack their reasons")
    if not (m["defer_backoffs"] > 0 and most <= 4):
        raise AssertionError(f"admit serve: defer_backoffs {m['defer_backoffs']}, "
                             f"largest concurrent {most}")
    if not launches == m["decode_steps"] * cfg.n_layers > 0:
        raise AssertionError(f"admit serve: paged_decode launches {launches} != "
                             f"decode_steps {m['decode_steps']} x {cfg.n_layers}")
    q, kp, vp, bt, cl = last["args"]
    got = paged_decode_cuda(q, kp, vp, bt, cl, **last["kw"])
    want = paged_decode_ref(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and got.shape == q.shape):
        raise AssertionError("admit serve: paged_decode output not finite")
    err = float((got.float() - want.float()).abs().max())
    same = sum(ungated["streams"].get(tuple(r.prompt.tolist())) == list(r.tokens)
               for r in requests)
    um, uw = ungated["metrics"], ungated["wall"]
    print(f"admit serve paged_decode on the gated pool (last step, cache_len="
          f"{cl.tolist()}): max_abs_err={err:.3e} (tol {TOL['bfloat16']})")
    print(f"admit serve gated / ungated: {m['tokens_out'] / wall:.1f} / "
          f"{um['tokens_out'] / uw:.1f} tokens/s; TTFT p50 {m['ttft_p50_ms']:.1f} / "
          f"{um['ttft_p50_ms']:.1f} ms; TPOT p50 {m['tpot_p50_ms']:.2f} / "
          f"{um['tpot_p50_ms']:.2f} ms; {same}/{len(requests)} streams equal the "
          f"ungated run's (bf16, other batch compositions: reported)")
    if not err <= TOL["bfloat16"]:
        raise AssertionError(f"admit serve: paged_decode disagrees: {err}")
    return {"launches": launches, "max_abs_err": err}


def admit_failover(cfg, params, scfg, prompts, engine) -> None:
    """Part 3: ``"backend"`` faults poison every estimate of the first six
    steps; the failover chain steps down to static degraded mode, at most
    ``ADMIT_DEGRADED_SLOTS`` requests run while it is degraded, every
    request finishes."""
    import dataclasses

    from repro_torch.serve import ContinuousEngine, Fault, FaultPlan, Request

    faults = FaultPlan([Fault(step=s, kind="backend", count=1000) for s in range(1, 7)])
    fcfg = dataclasses.replace(scfg, gamma_budget_mb=1e12, degraded_slots=ADMIT_DEGRADED_SLOTS,
                               health_fail_threshold=2, health_probe_every=4)
    ce = ContinuousEngine(cfg, params, fcfg, cost_engine=engine, faults=faults)
    requests = [Request(p[:256].copy(), max_new_tokens=16) for p in prompts[:8]]
    for r in requests:
        ce.submit(r)
    most_degraded, was_degraded = 0, False
    while not ce.idle:
        ce.step()
        if ce.failover.degraded:
            was_degraded = True
            most_degraded = max(most_degraded, ce.n_running)
    m = ce.metrics()
    print(f"admit failover: {m['finished']}/{len(requests)} finished, lost={m['lost']}, "
          f"degraded_steps={m['degraded_steps']}, failovers={m['failovers']}, largest "
          f"concurrent while degraded {most_degraded} (static slots "
          f"{ADMIT_DEGRADED_SLOTS}), backend faults fired {faults.fired['backend']}; "
          f"health {m['health']}")
    if not (was_degraded and m["finished"] == len(requests) and m["lost"] == 0
            and most_degraded <= ADMIT_DEGRADED_SLOTS):
        raise AssertionError(f"admit failover: {m}")


def admit_launcher() -> None:
    """Part 4: the launcher refuses full-width internlm2-1.8b at 20 GB on
    the h100 spec before drawing a parameter (the state alone is 22.68 GB)."""
    import torch

    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as T
    from repro_torch.serve import PlacementRefused

    draws = []
    init = T.init_params

    def counted(*a, **kw):
        draws.append(1)
        return init(*a, **kw)

    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    T.init_params = counted
    t0 = time.perf_counter()
    try:
        launch.main(["--arch", "internlm2-1.8b", "--steps", "1", "--batch", "4",
                     "--seq", "2048", "--device", "h100", "--memory-budget-gb", "20"])
    except PlacementRefused as e:
        refusal = e
    else:
        raise AssertionError("the launcher admitted internlm2-1.8b at 20 GB")
    finally:
        T.init_params = init
    secs = time.perf_counter() - t0
    print(f"admit launcher internlm2-1.8b B=4 S=2048 --device h100 --memory-budget-gb "
          f"20: refused in {secs:.2f} s, predicted {refusal.info['predicted_gb']:.3f} GB "
          f"(effective {refusal.info['gamma_eff'] / 1e3:.3f} GB), parameters drawn "
          f"{len(draws)}; {str(refusal)[:160]}")
    if draws or torch.cuda.memory_allocated() != alloc:
        raise AssertionError("the launcher drew parameters before refusing")


def admit_phase(cfg, params, scfg, prompts, ungated) -> dict:
    """Admission on the card (see the module docstring, phase 5b)."""
    from repro_torch.engine import AnalyticalBackend, CostEngine, from_torch_device

    spec = from_torch_device()
    backend = AnalyticalBackend(lm_device=spec)
    cache = ROOT / "build" / "repro_torch" / "admit_estimates.json"
    cache.unlink(missing_ok=True)
    engine = CostEngine(backend, cache=str(cache), device=spec)
    estimates = admit_estimates(engine, backend, spec)
    served = admit_serve(cfg, params, scfg, prompts, ungated, engine, backend)
    admit_failover(cfg, params, scfg, prompts, engine)
    admit_launcher()
    est = estimates[("qwen3-4b", "infer")]
    print(f"admit qwen3-4b infer bs=8 seq=2048: Γ {est.gamma_mb / 1e3:.3f} GB against "
          f"the ungated serve's max_memory_allocated "
          f"{ungated['max_memory_allocated'] / 1e9:.3f} GB (paged pool, chunked prefill)")
    return {**served, "train_estimate": estimates[("internlm2-1.8b", "train")]}


# ---------------------------------------------------------------------------
# The profiling campaign (repro_torch.campaign): full-width cells measured on
# the card, an LMForest fitted from them, qwen3-4b served under its admission
# ---------------------------------------------------------------------------

CAMPAIGN_ARCHS = ("stablelm-1.6b", "internlm2-1.8b", "qwen3-4b", "mamba2-780m")
CAMPAIGN_SEQ = 2048
CAMPAIGN_BATCHES = {"train": (1, 2, 4), "prefill": (1, 2, 4, 8), "decode": (8, 32)}
CAMPAIGN_MESH_ARCH = "stablelm-1.6b"    # its 1x2 row: the multi-device quarantine
# the plan's own seeded subsample (stratified by arch) keeps the run near
# two minutes and the script inside its time limit on a slow host; it
# always keeps the cells the serve admission queries (qwen3-4b prefill
# B 1-8) and the one set beside the train phase (internlm2-1.8b train B 4)
CAMPAIGN_SUBSAMPLE = 0.5
CAMPAIGN_REPEATS = dict(repeats=3, warmup=1)
# the reference's record keys (src/repro/campaign/runner.py:186-208)
CAMPAIGN_KEYS = ("arg_mb", "collective_bytes", "compile_s", "cost_classes",
                 "device_fingerprint", "energy_j", "executed", "flops", "gamma_mb",
                 "hbm_bytes", "layout", "n_devices", "phi_ms", "temp_mb", "watts_proxy")
CAMPAIGN_DIR = ROOT / "build" / "repro_torch" / "campaign"


def campaign_plan():
    """The card grid: the four archs × train B 1/2/4, prefill B 1/2/4/8 and
    decode B 8/32 at 2048 tokens on one device, under the registry's
    ``h100`` spec, subsampled (``CAMPAIGN_SUBSAMPLE``), plus
    ``CAMPAIGN_MESH_ARCH``'s cells on a 1x2 mesh."""
    from repro_torch.campaign import CampaignPlan, plan_grid
    from repro_torch.configs.base import ShapeSpec

    shapes = tuple(ShapeSpec(f"{kind}_b{b}_s{CAMPAIGN_SEQ}", CAMPAIGN_SEQ, b, kind)
                   for kind, bs in CAMPAIGN_BATCHES.items() for b in bs)
    grid = plan_grid(CAMPAIGN_ARCHS, shapes, meshes=("1x1",), device="h100",
                     reduced=False)
    sub = plan_grid(CAMPAIGN_ARCHS, shapes, meshes=("1x1",), device="h100",
                    reduced=False, subsample=CAMPAIGN_SUBSAMPLE, seed=0)
    drawn = {c.key for c in sub.cells}
    cells = [c for c in grid.cells if c.key in drawn
             or (c.arch == "qwen3-4b" and c.shape.kind == "prefill")
             or (c.arch == "internlm2-1.8b" and c.shape.name == "train_b4_s2048")]
    row = plan_grid((CAMPAIGN_MESH_ARCH,), shapes, meshes=("1x1", "1x2"),
                    device="h100", reduced=False)
    multi = [c for c in row.cells if c.mesh != "1x1"]
    return CampaignPlan(cells=cells + multi, seed=0,
                        skipped=grid.skipped + row.skipped,
                        meta={"grid": sub.meta, "multi_device": row.meta})


def campaign_run(plan) -> tuple[list, dict]:
    """Measure the plan on the card into a fresh ledger; gates: every cell
    measured or quarantined, every quarantine an out-of-memory or the
    multi-device ``MeshSpecError``, no kernel launched by a measured step
    (train and prefill run ``blocked_attention``, decode the dense cache),
    a second run measures nothing, and each record has the reference's
    keys, its layout and Γ ≥ arg > 0, Φ > 0.  The steps run on a tuner of
    their own (a fresh cache, timing on the card), so that the shapes they
    time do not reach the later phases' tuner gates."""
    from repro_torch.engine import from_torch_device
    from repro_torch.kernels import autotune

    CAMPAIGN_DIR.mkdir(parents=True, exist_ok=True)
    tuning = CAMPAIGN_DIR / "kernel_tuning.json"
    tuning.unlink(missing_ok=True)
    previous = autotune.get_tuner()
    autotune.set_tuner(autotune.KernelTuner(from_torch_device(), cache=str(tuning),
                                            measure=True))
    try:
        return campaign_measure(plan)
    finally:
        autotune.set_tuner(previous)


def campaign_measure(plan) -> tuple[list, dict]:
    import torch

    from repro_torch.campaign import CampaignLedger, CampaignRunner
    from repro_torch.campaign.runner import _measure_cell
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.collectives import abstract_mesh, layout_collectives

    ledger_path = CAMPAIGN_DIR / "ledger.jsonl"
    ledger_path.unlink(missing_ok=True)
    plan.save(str(CAMPAIGN_DIR / "plan.json"))
    rows = {}

    def measure(cell):
        t0 = time.perf_counter()
        traced = {}
        try:
            record, traced = _measure_cell(cell, **CAMPAIGN_REPEATS, run=True,
                                           device="cuda")
            return record
        finally:
            rows[cell.key] = (traced, time.perf_counter() - t0)

    resident = torch.cuda.memory_allocated()
    counts = kernel_counts()
    window = TunerWindow()
    runner = CampaignRunner(plan, str(ledger_path), measure=measure, device="cuda")
    t0 = time.perf_counter()
    out = runner.run_campaign()
    secs = time.perf_counter() - t0
    window.report("campaign")
    if {n: c[0] for n, c in kernel_counts().items()} != {n: c[0] for n, c in counts.items()}:
        raise AssertionError(f"campaign: a measured step launched a kernel: {counts} -> "
                             f"{kernel_counts()}")
    ledger = CampaignLedger(str(ledger_path))
    ok, failed = ledger.records("ok"), ledger.records("failed")
    print(f"campaign run {plan.plan_hash}: {len(plan)} cells ({len(plan.skipped)} skipped "
          f"at plan time), {out['measured']} measured, {out['failed']} quarantined in "
          f"{secs:.1f} s; resident before the run {resident / 2**30:.2f} GiB, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for r in ledger.records():
        traced, s = rows[r["key"]]
        label = f"campaign cell {r['arch']} {r['shape']['name']} [{r['mesh']}]"
        if r["status"] != "ok":
            print(f"{label}: QUARANTINED in {s:.2f} s: {r['error'][:200]}")
            continue
        tg = sum(traced.values()) / 1e6
        print(f"{label}: Γ {r['gamma_mb']:.1f} MB (arg {r['arg_mb']:.1f}, temp "
              f"{r['temp_mb']:.1f}), traced Γ {tg:.1f} MB ({tg / r['gamma_mb']:.3f}x), "
              f"Φ {r['phi_ms']:.3f} ms, first call {r['compile_s']:.2f} s, flops "
              f"{r['flops']:.4e}, hbm bytes {r['hbm_bytes']:.4e}, energy "
              f"{r['energy_j']:.3f} J, {s:.2f} s")
    if out["measured"] + out["failed"] != len(plan) or out["remaining"] != 0 \
            or len(ledger) != len(plan):
        raise AssertionError(f"campaign: cells lost: {out}")
    for r in failed:
        multi = r["mesh"] != "1x1"
        want = "MeshSpecError: " if multi else "OutOfMemoryError: "
        if not r["error"].startswith(want) or (multi and "(1 short)" not in r["error"]):
            raise AssertionError(f"campaign: unexpected quarantine {r['arch']} "
                                 f"{r['shape']['name']} [{r['mesh']}]: {r['error']}")
    if sum(c.mesh != "1x1" for c in plan.cells) != sum(r["mesh"] != "1x1" for r in failed):
        raise AssertionError("campaign: a multi-device cell was not quarantined")
    for r in ok:
        cell_shape = plan.cells[[c.key for c in plan.cells].index(r["key"])].shape
        want = layout_collectives(get_config(r["arch"]), cell_shape,
                                  abstract_mesh((1, 1))).to_dict()
        if tuple(sorted(k for k in r if k in CAMPAIGN_KEYS)) != CAMPAIGN_KEYS or \
                r["layout"] != want or not (r["gamma_mb"] >= r["arg_mb"] > 0
                                            and r["phi_ms"] > 0 and r["executed"]):
            raise AssertionError(f"campaign: bad record {r['arch']} {r['shape']['name']}")
    again = CampaignRunner(plan, str(ledger_path), measure=measure, device="cuda")
    if again.run_campaign()["measured"] != 0:
        raise AssertionError("campaign: the resumed run measured again")
    return ok, {"seconds": secs, "measured": out["measured"], "failed": out["failed"]}


def campaign_fit(records) -> tuple:
    """The LMForest (held-out Γ/Φ MAPE printed, not gated), saved and
    reloaded with identical predictions, and the cost-ledger constants
    (aggregate and class-wise MAPE printed)."""
    from repro_torch.campaign import LMForest, fit_hlo_constants, fit_lm_forest
    from repro_torch.campaign.lm_features import feature_matrix

    t0 = time.perf_counter()
    forest = fit_lm_forest(records, holdout_frac=0.25, seed=0)
    path = CAMPAIGN_DIR / "lm_forest.npz"
    forest.save(str(path))
    loaded = LMForest.load(str(path))
    X = feature_matrix(records)
    same = all(np.array_equal(a, b) for a, b in
               zip(forest.predict_features(X), loaded.predict_features(X)))
    m = forest.meta
    print(f"campaign fit LMForest on {m['n_train']} cells, {m['n_heldout']} held out: "
          f"held-out Γ MAPE {m.get('holdout_gamma_mape', float('nan')):.4f}, Φ MAPE "
          f"{m.get('holdout_phi_mape', float('nan')):.4f}, energy MAPE "
          f"{m.get('holdout_energy_mape', float('nan')):.4f} (reported, not gated); "
          f"OOB Γ {m['oob_gamma_mape']}, Φ {m['oob_phi_mape']}; device {m['device']}, "
          f"plan {m['plan_hash']}; saved to {path.relative_to(ROOT)} "
          f"({path.stat().st_size} bytes), reloaded: identical predictions {same}")
    if not (same and loaded.content_hash() == forest.content_hash()):
        raise AssertionError("campaign: the reloaded forest predicts otherwise")
    spec = fit_hlo_constants(records)
    sm = spec.meta
    print(f"campaign fit cost-ledger constants ({sm['n_cells']} cells): {sm['latency_fit']} "
          f"fit, Φ MAPE aggregate {sm['phi_mape_aggregate']:.4f}, class-wise "
          f"{sm['phi_mape_classwise']}; peak {spec.peak_flops:.4e} FLOP/s, hbm "
          f"{spec.hbm_bw:.4e} B/s, launch {spec.launch_overhead_s * 1e3:.3f} ms; "
          f"class-wise columns {sm['classwise_columns']}; energy {sm['energy_fit']} fit "
          f"({sm.get('energy_mape')}); {time.perf_counter() - t0:.1f} s")
    return forest, spec, path


def campaign_estimates(fitted, records, forest) -> dict:
    """internlm2-1.8b train B 4 × 2048 by the traced estimate on the
    registry's ``h100`` spec, then on the fitted constants, and by the
    forest, beside the campaign's own measurement of that cell."""
    from repro_torch.engine import AnalyticalBackend, CostQuery, get_device

    q = CostQuery(arch="internlm2-1.8b", bs=4, seq=2048, stage="train", reduced=False)
    out = {}
    for label, dev in (("before", get_device("h100")), ("after", fitted)):
        est = AnalyticalBackend(lm_device=dev).estimate([q])[0]
        out[label] = est
    g, p = forest.predict_queries([q])
    out["forest"] = (float(g[0]), float(p[0]))
    out["measured"] = next((r for r in records if r["arch"] == "internlm2-1.8b"
                            and r["shape"]["name"] == "train_b4_s2048"), None)
    b, a = out["before"], out["after"]
    meas = out["measured"]
    print(f"campaign internlm2-1.8b train B=4 S=2048: traced estimate on h100 Γ "
          f"{b.gamma_mb / 1e3:.3f} GB Φ {b.phi_ms:.2f} ms; on the fitted constants Γ "
          f"{a.gamma_mb / 1e3:.3f} GB Φ {a.phi_ms:.2f} ms ({a.detail['latency_fit']}); "
          f"forest Γ {out['forest'][0] / 1e3:.3f} GB Φ {out['forest'][1]:.2f} ms; the "
          f"campaign measured " + (f"Γ {meas['gamma_mb'] / 1e3:.3f} GB Φ "
                                   f"{meas['phi_ms']:.2f} ms" if meas else "nothing (quarantined)"))
    return out


def campaign_serve(cfg, params, scfg, prompts, ungated, forest) -> dict:
    """admit-qwen3-4b's 16 requests and weights under ``SLOScheduler``
    priced by the forest (``register_lm_forest`` on
    ``CostEngine(Ensemble[ForestBackend, AnalyticalBackend])``), with no
    estimate cache so that every query reaches the forest.  Budget: halfway
    between the forest's Γ at 4 and 5 requests × max_len, ×(1 + margin);
    gates: ``lost == 0``, at most k running (the largest k whose estimates
    at 1..k all fit), every admission query answered by the forest with
    no trace, no kernel launch and no allocation on the card, paged-decode
    launches ``decode_steps × 36`` and the kernel within 1e-2 of its plain
    version on the gated pool."""
    import dataclasses

    import torch

    from repro_torch.campaign import register_lm_forest
    from repro_torch.engine import (AnalyticalBackend, CostEngine, CostQuery,
                                    EnsembleBackend, ForestBackend, from_torch_device)
    from repro_torch.kernels.paged_decode import ops
    from repro_torch.kernels.paged_decode.kernel import paged_decode_cuda
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref
    from repro_torch.serve import ContinuousEngine, Request

    spec = from_torch_device()
    analytical = AnalyticalBackend(lm_device=spec)
    engine = CostEngine(EnsembleBackend([ForestBackend(), analytical]), device=spec)
    owner = register_lm_forest(engine, forest)
    margin = scfg.safety_margin
    gamma = {bs: engine.estimate_one(CostQuery(arch=cfg.name, bs=bs, seq=scfg.max_len,
                                               stage="infer", reduced=False)).gamma_mb
             for bs in range(1, scfg.n_slots + 1)}
    budget = ((1 + margin) * gamma[4] + (1 + margin) * gamma[5]) / 2
    k = 0
    while k < scfg.n_slots and (1 + margin) * gamma[k + 1] <= budget:
        k += 1
    print(f"campaign serve: forest Γ(bs 1..{scfg.n_slots}, max_len {scfg.max_len}) "
          + " / ".join(f"{gamma[b]:.1f}" for b in gamma) + f" MB, margin {margin}: "
          f"gamma_budget_mb {budget:.1f}, gate k {k}"
          + ("" if gamma[5] > gamma[4] else " (forest Γ(5) <= Γ(4): not monotone)"))
    if k < 1:
        raise AssertionError("campaign serve: the budget admits no request")
    answers = []
    estimate_one = engine.estimate_one

    def watched(query):
        torch.cuda.synchronize()
        counts, alloc = kernel_counts(), torch.cuda.memory_allocated()
        est = estimate_one(query)
        torch.cuda.synchronize()
        answers.append((est.source, bool(est.detail.get("lm")),
                        kernel_counts() == counts, torch.cuda.memory_allocated() == alloc))
        return est

    engine.estimate_one = watched
    gated = dataclasses.replace(scfg, gamma_budget_mb=budget)
    ce = ContinuousEngine(cfg, params, gated, cost_engine=engine)
    requests = [Request(p, max_new_tokens=32) for p in prompts]
    last = {}
    launch = ops.paged_decode_cuda

    def keep_last(*args, **kw):
        last["args"], last["kw"] = args, kw
        return launch(*args, **kw)

    traces = analytical.traces
    torch.cuda.synchronize()
    ops.paged_decode_cuda = keep_last
    paged_decode_cuda.launches = 0
    most = 0
    t0 = time.perf_counter()
    try:
        for r in requests:
            ce.submit(r)
        while not ce.idle:
            ce.step()
            most = max(most, ce.n_running)
        torch.cuda.synchronize()
    finally:
        ops.paged_decode_cuda = launch
        engine.estimate_one = estimate_one
    wall = time.perf_counter() - t0
    launches = paged_decode_cuda.launches
    m = ce.metrics()
    by_forest = sum(s == "forest" and lm for s, lm, _, _ in answers)
    print(f"campaign serve qwen3-4b forest-gated: {m['finished']} finished, {m['refused']} "
          f"refused, lost={m['lost']}, defer_backoffs={m['defer_backoffs']}, largest "
          f"concurrent {most} (gate k {k}), decode_steps={m['decode_steps']}, paged_decode "
          f"launches={launches}; {len(answers)} admission queries, {by_forest} answered by "
          f"the forest, analytical traces {analytical.traces - traces}; forest owner "
          f"{type(owner).__name__}")
    if not (m["finished"] == len(requests) and m["lost"] == 0 and m["refused"] == 0
            and most <= k):
        raise AssertionError(f"campaign serve: {m}, largest concurrent {most} > {k}?")
    if not (answers and by_forest == len(answers) and analytical.traces == traces
            and all(same and alloc for _, _, same, alloc in answers)):
        raise AssertionError("campaign serve: an admission query was not answered by "
                             "the forest alone, or it traced, launched or allocated")
    if not launches == m["decode_steps"] * cfg.n_layers > 0:
        raise AssertionError(f"campaign serve: paged_decode launches {launches} != "
                             f"decode_steps {m['decode_steps']} x {cfg.n_layers}")
    q, kp, vp, bt, cl = last["args"]
    got = paged_decode_cuda(q, kp, vp, bt, cl, **last["kw"])
    want = paged_decode_ref(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and got.shape == q.shape):
        raise AssertionError("campaign serve: paged_decode output not finite")
    err = float((got.float() - want.float()).abs().max())
    um, uw = ungated["metrics"], ungated["wall"]
    print(f"campaign serve paged_decode on the gated pool (last step, cache_len="
          f"{cl.tolist()}): max_abs_err={err:.3e} (tol {TOL['bfloat16']})")
    print(f"campaign serve forest-gated / ungated: {m['tokens_out'] / wall:.1f} / "
          f"{um['tokens_out'] / uw:.1f} tokens/s; TTFT p50 {m['ttft_p50_ms']:.1f} / "
          f"{um['ttft_p50_ms']:.1f} ms; TPOT p50 {m['tpot_p50_ms']:.2f} / "
          f"{um['tpot_p50_ms']:.2f} ms")
    if not err <= TOL["bfloat16"]:
        raise AssertionError(f"campaign serve: paged_decode disagrees: {err}")
    return {"launches": launches, "max_abs_err": err, "k": k}


def campaign_launcher(forest_path, forest) -> None:
    """The launcher with ``--lm-forest`` refuses full-width internlm2-1.8b
    (B 4 × 2048) at half the forest's Γ before drawing a parameter, on the
    forest's answer alone."""
    import torch

    from repro_torch.engine import AnalyticalBackend, CostQuery
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as T
    from repro_torch.serve import PlacementRefused

    g, _ = forest.predict_queries([CostQuery(arch="internlm2-1.8b", bs=4, seq=2048,
                                             stage="train", reduced=False)])
    tight = float(g[0]) / 2e3
    draws, traces = [], []
    init, trace = T.init_params, AnalyticalBackend._trace_arch

    def counted(*a, **kw):
        draws.append(1)
        return init(*a, **kw)

    def traced(self, q):
        traces.append(q)
        return trace(self, q)

    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    T.init_params, AnalyticalBackend._trace_arch = counted, traced
    t0 = time.perf_counter()
    try:
        launch.main(["--arch", "internlm2-1.8b", "--steps", "1", "--batch", "4",
                     "--seq", "2048", "--lm-forest", str(forest_path),
                     "--memory-budget-gb", f"{tight:.4f}"])
    except PlacementRefused as e:
        refusal = e
    else:
        raise AssertionError("the launcher admitted internlm2-1.8b under the forest")
    finally:
        T.init_params, AnalyticalBackend._trace_arch = init, trace
    print(f"campaign launcher internlm2-1.8b B=4 S=2048 --lm-forest --memory-budget-gb "
          f"{tight:.4f}: refused in {time.perf_counter() - t0:.2f} s by "
          f"{refusal.info['source']}, predicted {refusal.info['predicted_gb']:.3f} GB, "
          f"parameters drawn {len(draws)}, traces {len(traces)}")
    if draws or traces or refusal.info["source"] != "forest" or \
            torch.cuda.memory_allocated() != alloc:
        raise AssertionError("the launcher drew, traced or allocated before refusing")


def campaign_phase() -> dict:
    """The profiling campaign on the card (see the module docstring, phase
    5): plan, run, fit and the internlm2-1.8b estimates; the forest it
    returns gates the serve phase's qwen3-4b."""
    t0 = time.perf_counter()
    plan = campaign_plan()
    records, run = campaign_run(plan)
    forest, fitted, path = campaign_fit(records)
    estimates = campaign_estimates(fitted, records, forest)
    print(f"campaign phase: {len(plan)} cells, run {run['seconds']:.1f} s, plan to "
          f"estimates {time.perf_counter() - t0:.1f} s")
    return {"forest": forest, "path": path, "estimates": estimates}


def paged_steps(cfg, dev: str, steps, n_blocks: int, block_size: int) -> tuple[list, int]:
    """``decode_step`` over a paged pool on ``dev`` (the f32 parameters of
    seed 0, the pool in its default bf16) for each (tokens, cache_len,
    block_table) of ``steps`` → (each step's logits on the CPU, the paged
    decode kernel's launches meanwhile)."""
    import torch

    from repro_torch.kernels.paged_decode.kernel import paged_decode_cuda
    from repro_torch.models import transformer as T

    params = T.init_params(cfg, 0, device=dev, dtype=torch.float32)
    pool = T.init_paged_cache(cfg, n_blocks, block_size, device=dev)
    paged_decode_cuda.launches = 0
    out = []
    for tokens, cache_len, table in steps:
        lg, pool = T.decode_step(params, pool, {
            "tokens": torch.tensor(tokens, dtype=torch.int32, device=dev),
            "cache_len": torch.tensor(cache_len, dtype=torch.int32, device=dev),
            "block_table": torch.tensor(table, dtype=torch.int32, device=dev),
        }, cfg)
        out.append(lg.float().cpu())
    return out, paged_decode_cuda.launches


def reference_phase() -> int:
    """Reduced qwen3-4b in f32 (head_dim 64, the smallest the kernel takes;
    4 query heads over 2 KV heads): a chunked-prefill chunk and decode
    steps over the paged pool on the card (the 3xTF32 kernel: f32 q over
    the bf16 pool) and on the CPU (the plain path) give the same logits.
    Tolerance: atol 2e-3 (K/V sit in a bf16 pool, where f32 noise can flip
    one rounding).  Returns the kernel's launches: one a decode step and
    layer."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config("qwen3-4b", reduced=True),
                              head_dim=64, n_kv_heads=2)
    rng = np.random.default_rng(3)
    steps = [(rng.integers(2, 512, (1, 16)), [0], [[1, 2]])]
    cl = np.array([13, 0, 7])
    for _ in range(4):
        steps.append((rng.integers(2, 512, (3, 1)), cl.tolist(),
                      [[1, 2, 3], [0, 0, 0], [4, 5, 6]]))
        cl = cl + [1, 0, 1]
    cpu, _ = paged_steps(cfg, "cpu", steps, 9, 8)
    card, launches = paged_steps(cfg, "cuda", steps, 9, 8)
    err = max(float((a - b).abs().max()) for a, b in zip(cpu, card))
    want = 4 * cfg.n_layers
    print(f"reference reduced qwen3-4b f32 paged decode, card vs CPU logits: "
          f"max_abs_err={err:.3e} (tol 2e-3); paged_decode launches {launches} "
          f"(4 decode steps x {cfg.n_layers} layers = {want})")
    if not err <= 2e-3:
        raise AssertionError(f"card disagrees with the CPU path: {err}")
    if launches != want:
        raise AssertionError(f"reference: paged_decode launches {launches} != {want}")
    return launches


# ---------------------------------------------------------------------------
# The non-dense layer plans: MoE, SSD and cross-attention
# ---------------------------------------------------------------------------

# card against CPU, every registry architecture at smoke size in f32 (TF32
# off, tuning pinned to the configs' constants on both devices): f32 sums
# in other orders (~1e-6), and K/V read back from a bf16 cache where f32
# noise may round an entry to the other bf16 neighbour, which moves a
# logit by up to one bf16 ulp (2^-8) of the largest (1.9e-3 seen, whisper's
# prefill); relative to the largest logit
LAYERS_CPU_TOL = 2.0 ** -8
# decode against forward, the reference's own check
# (tests/test_lm_models.py:64): the last token's logits, relative to the
# largest.  It holds in bf16 at the reference's 2 layers; over mamba2's 48
# the bf16 rounding of the chunked scan's output (the recurrence keeps f32)
# compounds, in the reference as in the port
# (tests/test_torch_ssd_block.py), so full-depth mamba2 is gated in f32
# on its bf16 weights and its bf16 error is printed
DECODE_REL_TOL = 0.05
# mamba2-780m served by the lockstep engine: 8 ragged prompts of 256-1024
# tokens (the longest 1024, so the SSD scan's prefill width is 1024), 64
# greedy new tokens each
MAMBA_SLOTS, MAMBA_NEW = 8, 64
# qwen3-moe-30b-a3b at full width with its depth cut to 4 of 48 layers
MOE_LAYERS = 4
# whisper-tiny at full width: 2 requests of 32 tokens over its 1500 frames
WHISPER_B, WHISPER_S, WHISPER_STEPS = 2, 32, 8


def decode_rel_err(params, cfg, batch, pos_offset=None) -> float:
    """prefill(prompt) → greedy token → one decode_step, against forward
    over prompt + token: max |Δ logits| / max |logits| of the last
    position."""
    import torch

    from repro_torch.models import transformer as T

    tokens = batch["tokens"]
    S = tokens.shape[1] + cfg.n_prefix
    pb = dict(batch)
    if pos_offset is not None:
        pb["pos_offset"] = pos_offset
    pf = T.prefill(params, pb, cfg, max_len=S + 1)
    tok = pf["logits"][:, -1].float().argmax(-1).to(torch.int32)[:, None]
    db = {"tokens": tok, "cache_len": pf["cache_len"]}
    if "memory" in pf:
        db["memory"] = pf["memory"]
    if pos_offset is not None:
        db["pos_offset"] = pos_offset
    dec, _ = T.decode_step(params, pf["cache"], db, cfg)
    fb = dict(pb, tokens=torch.cat([tokens, tok], dim=1))
    with torch.no_grad():
        full, _ = T.forward(params, fb, cfg)
    ref, got = full[:, -1].float(), dec[:, 0].float()
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise AssertionError(f"{cfg.name}: decode or forward logits not finite")
    return float((ref - got).abs().max() / ref.abs().max())


@contextlib.contextmanager
def pinned_tuning():
    """Tuning off (the configs' constants) for the block inside."""
    old = os.environ.get("REPRO_AUTOTUNE")
    os.environ["REPRO_AUTOTUNE"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_AUTOTUNE"]
        else:
            os.environ["REPRO_AUTOTUNE"] = old


def traced_breakdown(label: str, step, n_steps: int = 8) -> None:
    """Where ``step``'s time goes: ``n_steps`` calls timed on the host
    clock, then ``n_steps`` more traced with ``torch.profiler`` (CUDA
    activity only); device time, idle share and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + t / 1e3 / n_steps
    dev_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"{label}: host wall {wall_ms:.2f} ms, device kernel time {dev_ms:.2f} ms "
          f"(device idle {1 - dev_ms / wall_ms:.1%}); top kernels (ms): " + "; ".join(
              f"{k[:60]} {t:.3f}" for k, t in top))


def layers_card_vs_cpu() -> None:
    """(1) Every registry architecture at ``reduced()`` in f32: ``forward``
    logits and ``prefill`` + one ``decode_step`` (with the encoder's memory
    for whisper) on the card against the same model on the CPU."""
    import torch

    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.models import transformer as T

    worst = {}
    with pinned_tuning():
        for arch in ARCH_IDS:
            cfg = get_config(arch, reduced=True)
            rng = np.random.default_rng(6)
            batch = {"tokens": rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32)}
            if cfg.n_prefix:
                batch["patches"] = rng.standard_normal(
                    (2, cfg.n_prefix, cfg.d_model)).astype(np.float32)
            if cfg.n_encoder_layers:
                batch["frames"] = rng.standard_normal(
                    (2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
            out = {}
            for dev in ("cpu", "cuda"):
                params = T.init_params(cfg, 0, device=dev, dtype=torch.float32)
                b = {k: torch.tensor(v, device=dev) for k, v in batch.items()}
                with torch.no_grad():
                    fwd, aux = T.forward(params, b, cfg)
                pf = T.prefill(params, dict(b, tokens=b["tokens"][:, :-1]), cfg,
                               max_len=17 + cfg.n_prefix)
                db = {"tokens": b["tokens"][:, -1:], "cache_len": pf["cache_len"]}
                if "memory" in pf:
                    db["memory"] = pf["memory"]
                dec, _ = T.decode_step(params, pf["cache"], db, cfg)
                out[dev] = [t.float().cpu() for t in (fwd, pf["logits"], dec)] + [float(aux)]
            errs = [float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                    for a, b in zip(out["cuda"][:3], out["cpu"][:3])]
            worst[arch] = max(errs)
            print(f"layers {arch} reduced f32, card vs CPU: forward {errs[0]:.3e}, "
                  f"prefill {errs[1]:.3e}, decode {errs[2]:.3e} (relative to the "
                  f"largest logit, tol {LAYERS_CPU_TOL}); aux {out['cuda'][3]:.6f} / "
                  f"{out['cpu'][3]:.6f}")
            if not all(torch.isfinite(t).all() for t in out["cuda"][:3]):
                raise AssertionError(f"{arch}: card logits not finite")
    bad = {a: e for a, e in worst.items() if not e <= LAYERS_CPU_TOL}
    print(f"layers card vs CPU, {len(worst)} architectures: worst "
          f"{max(worst, key=worst.get)} at {max(worst.values()):.3e}")
    if bad:
        raise AssertionError(f"card disagrees with the CPU: {bad}")


def layers_paged_card_vs_cpu() -> int:
    """(1b) Every registry architecture with a pure self-attention stack and
    no prefix or encoder, at ``reduced()`` in f32 with head_dim 64 (the
    smallest the paged decode kernel takes): a chunked-prefill chunk of 12
    tokens and two decode steps over the paged pool (bf16), on the card
    (the 3xTF32 kernel: f32 q over the bf16 pool) against the CPU, relative
    to the largest logit within ``LAYERS_CPU_TOL``.  Returns the kernel's
    launches, one a decode step and layer of causal attention."""
    import dataclasses

    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.models import transformer as T

    rng = np.random.default_rng(7)
    total, worst = 0, {}
    with pinned_tuning():
        for arch in ARCH_IDS:
            cfg = dataclasses.replace(get_config(arch, reduced=True), head_dim=64)
            if cfg.n_prefix or cfg.n_encoder_layers:
                continue
            try:
                T.paged_cache_shapes(cfg, 1, 8)
            except ValueError:             # an SSD or cross-attention mixer
                continue
            table = [[1, 2, 3], [4, 5, 6]]
            steps = [(rng.integers(0, cfg.vocab, (2, 12)), [0, 0], table),
                     (rng.integers(0, cfg.vocab, (2, 1)), [12, 12], table),
                     (rng.integers(0, cfg.vocab, (2, 1)), [13, 13], table)]
            cpu, _ = paged_steps(cfg, "cpu", steps, 7, 8)
            card, launches = paged_steps(cfg, "cuda", steps, 7, 8)
            worst[arch] = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                              for a, b in zip(card, cpu))
            # chunked attention (llama4) reads the gathered view, as the
            # reference's does: no kernel launch
            want = 0 if cfg.attention == "chunked" else 2 * cfg.n_layers
            print(f"layers {arch} reduced f32 head_dim 64 over the paged pool, card vs CPU: "
                  f"{worst[arch]:.3e} (relative to the largest logit, tol {LAYERS_CPU_TOL}); "
                  f"paged_decode launches {launches} (expected {want}: 2 decode steps x "
                  f"{cfg.n_layers} layers, {cfg.attention} attention)")
            if launches != want:
                raise AssertionError(f"{arch}: paged_decode launches {launches} != {want}")
            total += launches
    bad = {a: e for a, e in worst.items() if not e <= LAYERS_CPU_TOL}
    print(f"layers paged card vs CPU, {len(worst)} architectures: worst "
          f"{max(worst, key=worst.get)} at {max(worst.values()):.3e}; paged_decode launches "
          f"{total}")
    if bad:
        raise AssertionError(f"card disagrees with the CPU over the paged pool: {bad}")
    return total


def layers_mamba() -> dict:
    """(2) Full-width mamba2-780m (48 layers, bf16, seed 0) served by the
    lockstep ``ServeEngine``: the SSD chunk of the prefill comes from the
    tuner, which times the SSD kernel at the prefill's shape (four
    launches per timed config, none on the main path); then prefill ms,
    TPOT and tokens/s of a second run; and the decode-against-forward
    gate."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import autotune
    from repro_torch.kernels.ssm_scan import tiling as ssm_tiling
    from repro_torch.kernels.ssm_scan.kernel import ssd_chunk_cuda
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.engine import pad_ragged

    cfg = get_config("mamba2-780m")
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    lens = rng.integers(256, 1025, MAMBA_SLOTS)
    lens[0] = 1024
    prompts = [rng.integers(2, cfg.vocab, (int(n),)).astype(np.int32) for n in lens]
    S0 = int(lens.max())
    scfg = ServeConfig(max_len=S0 + MAMBA_NEW + 2, n_slots=MAMBA_SLOTS, eos_id=-1)
    engine = ServeEngine(cfg, params, scfg, device="cuda")

    tuner = autotune.get_tuner()
    timed, t_launches = tuner.timed, ssd_chunk_cuda.tuner_launches
    ssd_chunk_cuda.launches = 0
    window = TunerWindow()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = engine.generate(prompts, max_new_tokens=MAMBA_NEW)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    window.report("layers mamba2")
    timed = tuner.timed - timed
    tuner_launches = ssd_chunk_cuda.tuner_launches - t_launches
    main_launches = ssd_chunk_cuda.launches
    d_inner = cfg.ssm_expand * cfg.d_model
    key = ssm_tiling.shape_key((MAMBA_SLOTS, S0, d_inner // cfg.ssm_head_dim,
                                cfg.ssm_head_dim), cfg.ssm_state, dtype=T.DTYPE)
    entry = [e for e in tuner.cache.entries()
             if e["kernel"] == "ssm_scan" and e["shape"] == key]
    chunk = entry[0]["config"]["chunk"] if entry else None
    print(f"layers mamba2 ssm_scan tuning at the prefill shape "
          f"{json.dumps(key, sort_keys=True)}: {entry}")
    print(f"layers mamba2 ssd_chunk: {timed} configs timed -> tuner_launches="
          f"{tuner_launches} (expected {4 * timed}), main-path launches {main_launches}")
    if not (len(entry) == 1 and entry[0]["source"] == "timed"
            and tuner_launches == 4 * timed > 0 and main_launches == 0):
        raise AssertionError("the SSD chunk was not tuned on the card as counted")

    tokens, plens = pad_ragged(prompts)
    batch = {"tokens": torch.tensor(tokens, device="cuda")}
    pos_offset = torch.tensor(S0 - plens, dtype=torch.int32, device="cuda")
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.prefill(params, dict(batch, pos_offset=pos_offset), cfg, max_len=scfg.max_len)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = statistics.median(prefill_ms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=MAMBA_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_out = int(out["token_counts"].sum())
    tpot_ms = (wall * 1e3 - prefill_ms) / (out["tokens"].shape[1] - 1)
    if not (np.array_equal(out["tokens"], first["tokens"])
            and out["tokens"].shape == (MAMBA_SLOTS, MAMBA_NEW)
            and ((0 <= out["tokens"]) & (out["tokens"] < cfg.padded_vocab())).all()):
        raise AssertionError("mamba2 greedy streams differ between two runs or are bad")
    pf = T.prefill(params, dict(batch, pos_offset=pos_offset), cfg, max_len=scfg.max_len)
    traced_breakdown("layers mamba2 prefill of 8 x 1024 tokens", lambda: T.prefill(
        params, dict(batch, pos_offset=pos_offset), cfg, max_len=scfg.max_len), 2)
    state = {"cache": pf["cache"], "len": pf["cache_len"],
             "tok": pf["logits"][:, -1].argmax(-1).to(torch.int32)[:, None]}

    def decode():
        logits, _ = T.decode_step(params, state["cache"], {
            "tokens": state["tok"], "cache_len": state["len"],
            "pos_offset": pos_offset}, cfg)
        state["tok"] = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        state["len"] += 1

    traced_breakdown("layers mamba2 decode step, 8 slots", decode)
    del pf, state
    with pinned_tuning():
        rel_bf16 = decode_rel_err(params, cfg, batch, pos_offset)
        rel = decode_rel_err(params.float(), cfg, batch, pos_offset)
    print(f"layers mamba2-780m full width ({cfg.param_count() / 1e9:.4f}e9 parameters, "
          f"{cfg.n_layers} layers, d {cfg.d_model}, {d_inner // cfg.ssm_head_dim} SSD "
          f"heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}) bf16 seed 0: init_params "
          f"{init_s:.1f} s; ServeEngine(n_slots={MAMBA_SLOTS}) over prompts of "
          f"{lens.tolist()} tokens, {MAMBA_NEW} greedy tokens each: first run (tuning "
          f"included) {first_s:.3f} s; second run {wall:.3f} s = {n_out / wall:.1f} "
          f"tokens/s, prefill {prefill_ms:.1f} ms (median of 3), TPOT {tpot_ms:.2f} ms; "
          f"tuned SSD chunk {chunk}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"layers mamba2 decode vs forward (forward over prompt + token, tuning pinned "
          f"to chunk {cfg.ssm_chunk}): max relative error in bf16 {rel_bf16:.4f} (not "
          f"gated: bf16 rounding over 48 layers, see DECODE_REL_TOL), in f32 (the same "
          f"weights) {rel:.3e} (tol {DECODE_REL_TOL})")
    if not rel <= DECODE_REL_TOL:
        raise AssertionError(f"mamba2 decode disagrees with forward: {rel}")
    del params, engine
    torch.cuda.empty_cache()
    return {"serve_launches": tuner_launches, "main_launches": main_launches}


def layers_moe(drawing) -> dict:
    """(3) Full-width qwen3-moe-30b-a3b, depth cut to ``MOE_LAYERS``,
    served by ``ContinuousEngine`` over the paged pool as the serve phase
    serves qwen3-4b; the paged decode kernel's launches counted and the
    kernel held against its plain version on the served inputs; the
    tuner's (groups, capacity_factor) for each MoE shape, and the share of
    (token, expert) pairs dropped in one prefill.  ``drawing`` is the
    :func:`host_draw` of the cut model, started with the layers phase."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import autotune
    from repro_torch.kernels.paged_decode import ops
    from repro_torch.kernels.paged_decode.kernel import paged_decode_cuda
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve import ContinuousConfig, ContinuousEngine, Request

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    params, draw_s = drawing.result()
    params = params.to("cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    scfg = ContinuousConfig(n_slots=8, max_len=2048, prefill_chunk=512)
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1537, 16)
    prompts = [rng.integers(2, cfg.vocab, (int(n),)).astype(np.int32) for n in lens]

    ContinuousEngine(cfg, params, scfg, device="cuda").run(   # warm-up: handles, pools
        [Request(p[:100], max_new_tokens=4) for p in prompts[:2]])
    engine = ContinuousEngine(cfg, params, scfg, device="cuda")
    calls, launch = [], ops.paged_decode_cuda

    def keep_last(*args, **kw):    # the served model's own kernel inputs
        calls.append((args, kw))
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
    window.report("layers qwen3-moe")
    m = engine.metrics()
    print(f"layers qwen3-moe-30b-a3b full width, {MOE_LAYERS} of 48 layers "
          f"({cfg.param_count() / 1e9:.4f}e9 parameters, {cfg.n_experts} experts top-"
          f"{cfg.experts_per_token} of d_ff {cfg.moe_d_ff_}) bf16 seed 0: init_params "
          f"{draw_s:.1f} s on the host beside the earlier parts, on the card {init_s:.1f} "
          f"s after them; ContinuousEngine n_slots=8 max_len=2048 prefill_chunk=512: "
          f"{m['finished']}/{len(requests)} finished, lost={m['lost']}, decode_steps="
          f"{m['decode_steps']}, paged_decode launches={launches}, preemptions="
          f"{m['preemptions']}, prefill_chunks={m['prefill_chunks']}")
    if m["finished"] != len(requests) or m["lost"] != 0:
        raise AssertionError(f"not every MoE request finished: {m}")
    if not launches == m["decode_steps"] * MOE_LAYERS > 0:
        raise AssertionError(f"paged_decode launches {launches} != decode_steps "
                             f"{m['decode_steps']} x {MOE_LAYERS}")
    vocab = cfg.padded_vocab()
    for r in engine.finished:
        if not (len(r.tokens) and all(0 <= t < vocab for t in r.tokens)):
            raise AssertionError(f"request {r.rid}: bad tokens {r.tokens}")
    print(f"layers qwen3-moe {m['tokens_out']} tokens in {wall:.3f} s = "
          f"{m['tokens_out'] / wall:.1f} tokens/s; TTFT p50 {m['ttft_p50_ms']:.1f} ms "
          f"p99 {m['ttft_p99_ms']:.1f} ms; TPOT p50 {m['tpot_p50_ms']:.2f} ms p99 "
          f"{m['tpot_p99_ms']:.2f} ms; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for e in autotune.get_tuner().cache.entries():
        if e["kernel"] == "moe_dispatch":
            print(f"layers qwen3-moe moe_dispatch {json.dumps(e['shape'], sort_keys=True)}: "
                  f"config {e['config']} source {e['source']} (default "
                  f"{e['default_config']})")

    # the last layer's call of the step with the most live slots (the last
    # step may hold one): the pool as the run left it, the step's own
    # queries, table and fills
    busiest = max(range(MOE_LAYERS - 1, len(calls), MOE_LAYERS),
                  key=lambda i: (int((calls[i][0][4] > 0).sum()), i))
    (q, kp, vp, bt, cl), kw = calls[busiest]
    got = paged_decode_cuda(q, kp, vp, bt, cl, **kw)
    want = paged_decode_ref(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and got.shape == q.shape):
        raise AssertionError("paged_decode output on the MoE model's inputs not finite")
    err = float((got.float() - want.float()).abs().max())
    print(f"layers qwen3-moe paged_decode on the served pool (last layer of decode "
          f"step {busiest // MOE_LAYERS + 1}, the busiest, H {cfg.n_heads} Hkv "
          f"{cfg.n_kv_heads} Dh {cfg.head_dim_}, cache_len={cl.tolist()}): "
          f"max_abs_err={err:.3e} (tol {TOL['bfloat16']})")
    if not err <= TOL["bfloat16"]:
        raise AssertionError(f"paged_decode disagrees on the MoE model's inputs: {err}")
    del engine, calls, q, kp, vp, got, want
    decode_breakdown(cfg, params, scfg, prompts)

    # the share of (token, expert) pairs dropped in one prefill (1024 tokens)
    dispatch, drops = L._moe_dispatch_group, []

    def counted(xt, ids, E, K, C):
        buf, route = dispatch(xt, ids, E, K, C)
        drops.append((int((route[1] == C).sum()), route[1].numel(), C, xt.shape[0]))
        return buf, route

    tokens = np.random.default_rng(9).integers(2, cfg.vocab, (1, 1024))
    L._moe_dispatch_group = counted
    try:
        T.prefill(params, {"tokens": torch.tensor(tokens, dtype=torch.int32,
                                                  device="cuda")}, cfg, max_len=1024)
        torch.cuda.synchronize()
    finally:
        L._moe_dispatch_group = dispatch
    dropped, pairs = sum(d[0] for d in drops), sum(d[1] for d in drops)
    print(f"layers qwen3-moe one prefill of 1024 tokens: {dropped} of {pairs} (token, "
          f"expert) pairs dropped = {dropped / pairs:.4%} (per layer "
          f"{[d[0] for d in drops]}, capacity {drops[0][2]} slots per expert, "
          f"{drops[0][3]} group(s))")
    del params
    torch.cuda.empty_cache()
    return {"moe_launches": launches, "moe_max_abs_err": err}


def layers_whisper() -> None:
    """(4) Full-width whisper-tiny (4 + 4 layers, d 384, seed 0, bf16):
    ``prefill`` over 1500 frames and ``WHISPER_STEPS`` greedy decode steps
    with the encoder's memory; finite logits and the decode-against-forward
    gate."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("whisper-tiny")
    params = T.init_params(cfg, 0, device="cuda")
    rng = np.random.default_rng(8)
    tokens = torch.tensor(rng.integers(2, cfg.vocab, (WHISPER_B, WHISPER_S)),
                          dtype=torch.int32, device="cuda")
    frames = torch.tensor(rng.standard_normal((WHISPER_B, cfg.n_audio_frames, cfg.d_model)),
                          dtype=T.DTYPE, device="cuda")
    batch = {"tokens": tokens, "frames": frames}
    rel = decode_rel_err(params, cfg, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pf = T.prefill(params, batch, cfg, max_len=WHISPER_S + WHISPER_STEPS)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    cache, cl, tok = pf["cache"], pf["cache_len"], pf["logits"][:, -1].argmax(-1)
    t0 = time.perf_counter()
    for _ in range(WHISPER_STEPS):
        logits, cache = T.decode_step(params, cache, {
            "tokens": tok.to(torch.int32)[:, None], "cache_len": cl,
            "memory": pf["memory"]}, cfg)
        if not torch.isfinite(logits).all():
            raise AssertionError("whisper decode logits not finite")
        tok, cl = logits[:, -1].argmax(-1), cl + 1
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / WHISPER_STEPS
    print(f"layers whisper-tiny full width ({cfg.param_count() / 1e6:.2f}e6 parameters, "
          f"{cfg.n_encoder_layers} + {cfg.n_layers} layers, d {cfg.d_model}) bf16 seed 0: "
          f"prefill of B={WHISPER_B} x {WHISPER_S} tokens over "
          f"{cfg.n_audio_frames} frames {prefill_ms:.1f} ms, memory "
          f"{tuple(pf['memory'].shape)}; {WHISPER_STEPS} decode steps with the memory, "
          f"{step_ms:.2f} ms/step; decode vs forward max relative error {rel:.4f} "
          f"(tol {DECODE_REL_TOL})")
    if not rel <= DECODE_REL_TOL:
        raise AssertionError(f"whisper decode disagrees with forward: {rel}")


def layers_phase() -> dict:
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config

    t0 = time.perf_counter()
    # qwen3-moe's weights are drawn on the host beside the first two parts
    drawing = host_draw(dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                                            n_layers=MOE_LAYERS))
    layers_card_vs_cpu()
    paged_launches = layers_paged_card_vs_cpu()
    mamba = layers_mamba()
    moe = layers_moe(drawing)
    layers_whisper()
    torch.cuda.empty_cache()
    print(f"layers phase done in {time.perf_counter() - t0:.1f} s")
    return {**mamba, **moe, "paged_launches": paged_launches}


# ---------------------------------------------------------------------------
# Training: loss_fn, the optimizer, the Trainer and its checkpoints
# ---------------------------------------------------------------------------

# full-width internlm2-1.8b (the reference launcher's model) trained at
# batch 4 over 2048 tokens for 6 steps, bf16, AdamW, seed 0
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "internlm2-1.8b", 4, 2048, 6
# then steps at the sequence length of the reference's training shape
# (train_4k), with the same 8192 tokens a step: one warm-up, 3 timed, 1 traced
TRAIN_REF_BATCH, TRAIN_REF_SEQ, TRAIN_REF_STEPS = 2, 4096, 3
# card against CPU, reduced internlm2-1.8b in f32 with TF32 off: both sum
# in f32 in other orders (the embedding's backward with atomics on the
# card), which moves a gradient by ~1e-6 of its norm
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
# memory after init_state against bf16 params + bf16 grads + f32 m and v
TRAIN_STATE_TOL = 0.02
# the chunked loss against the unchunked one on the same state, relative:
# both round the same bf16 logits and sum in f32 in other orders; one
# unmasked pad position per row (S-1 = 2047 pads to 2048) moves it ~2e-5
TRAIN_CHUNK_TOL = 1e-5


def flat_leaves(tree: dict, path: tuple = ()) -> dict:
    """{"a/b/c": leaf} of nested dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = v
    return out


def train_grad_check() -> None:
    """(a) One ``loss_fn`` + backward of reduced internlm2-1.8b in f32 on
    the card and on the CPU (TF32 off): the loss within
    ``TRAIN_LOSS_TOL`` relative, every gradient leaf within
    ``TRAIN_GRAD_TOL`` of its norm."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.convert import grads_to_numpy
    from repro_torch.models import transformer as T

    cfg = get_config(TRAIN_ARCH, reduced=True)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 64)).astype(np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        model = T.init_params(cfg, 0, device=dev, dtype=torch.float32).requires_grad_(True)
        loss, _ = T.loss_fn(model, {"tokens": torch.tensor(tokens, device=dev)}, cfg)
        loss.backward()
        out[dev] = (loss.item(), flat_leaves(grads_to_numpy(model, cfg)))
    loss_err = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    errs = {k: float(np.linalg.norm(out["cuda"][1][k] - g) / np.linalg.norm(g))
            for k, g in out["cpu"][1].items()}
    worst = max(errs, key=errs.get)
    print(f"train reduced {TRAIN_ARCH} f32 loss_fn + backward, card vs CPU (TF32 off): "
          f"loss {out['cuda'][0]:.6f} / {out['cpu'][0]:.6f}, relative error "
          f"{loss_err:.3e} (tol {TRAIN_LOSS_TOL}); {len(errs)} gradient leaves, worst "
          f"{worst} at {errs[worst]:.3e} of its norm (tol {TRAIN_GRAD_TOL})")
    if not (loss_err <= TRAIN_LOSS_TOL and errs[worst] <= TRAIN_GRAD_TOL):
        raise AssertionError("the card's training gradients disagree with the CPU's")


def train_tune_check() -> dict:
    """(b) ``warm_autotune(stages=("train",))`` for full-width
    internlm2-1.8b at the training shape on the tuner the tune phase
    installed: (4, 16/8, 2048, 128, causal, bf16) is a new flash shape, so
    it is timed (four launches per config, none on the main path); then
    the kernel against its plain version there, and kernel, plain version,
    ``scaled_dot_product_attention`` and the bound timed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attention import tiling as flash_tiling
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import transformer as T

    cfg = get_config(TRAIN_ARCH)
    tuner, kernel = autotune.get_tuner(), flash_attention_cuda
    timed, tuner_launches, launches = tuner.timed, kernel.tuner_launches, kernel.launches
    warm = T.warm_autotune(cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                           stages=("train",))
    timed = tuner.timed - timed
    tuner_launches = kernel.tuner_launches - tuner_launches
    B, H, Hkv, S, Dh = TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads, TRAIN_SEQ, cfg.head_dim_
    key = flash_tiling.shape_key((B, H, S, Dh), (B, Hkv, S, Dh), causal=True, dtype=T.DTYPE)
    entry = [e for e in tuner.cache.entries()
             if e["kernel"] == "flash_attention" and e["shape"] == key]
    print(f"train tune warm_autotune({TRAIN_ARCH}, batch {B}, seq {S}, train) -> {warm}; "
          f"flash_attention {json.dumps(key, sort_keys=True)}: {timed} configs timed -> "
          f"tuner_launches={tuner_launches} (expected {4 * timed}), main-path launches "
          f"{kernel.launches - launches}; entry {entry}")
    if not (tuner_launches == 4 * timed > 0 and kernel.launches == launches
            and len(entry) == 1 and entry[0]["source"] == "timed"):
        raise AssertionError("the training shape was not timed by the tuner as counted")
    config = tuner.tune("flash_attention", key)
    gen = torch.Generator(device="cuda").manual_seed(5)
    err, (q, k, v, _) = flash_check(gen, f"{TRAIN_ARCH} training shape (tuned)", B, H, Hkv,
                                    S, S, Dh, torch.bfloat16, **config)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    ms = time_ms(lambda: flash_attention_cuda(q, k, v, **config), flush, 10, 2)
    plain_ms = time_ms(lambda: attention_ref(q, k, v), flush, 5, 1)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True),
                         flush, 10, 2)
    del flush, q, k, v, kr, vr
    flops = 4 * B * H * S * S * Dh * 0.5
    nbytes = 2 * (2 * B * H * S * Dh + 2 * B * Hkv * S * Dh)
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    print(f"timing flash_attention {TRAIN_ARCH} training shape B={B} H={H} Hkv={Hkv} "
          f"S={S} Dh={Dh} bf16 causal at {config}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}) -> "
          f"{bound_ms / ms:.1%} of bound")
    return {"train_launches": tuner_launches, "train_max_abs_err": err, "train_ms": ms,
            "train_plain_ms": plain_ms, "train_bound_ms": bound_ms,
            "train_library_ms": library_ms}


# kernel classes of a training step, by kernel name, first match wins
STEP_CLASSES = [
    ("f32 GEMMs (attention scores)", r"sgemm|gemm_f32f32_f32f32|nvjet_sss"),
    ("bf16 GEMMs", r"gemm|nvjet|cutlass|xmma"),
    ("dtype casts and copies", r"copy"),
    ("softmax", r"softmax"),
    ("other elementwise and reductions", r"elementwise|reduce"),
]


def train_model_flops(cfg, n: int, batch: int, seq: int) -> tuple[float, float]:
    """(model FLOPs of one step, of which causal attention): 6·N·T plus
    the causal QK and PV products, forward and backward."""
    attn = 3 * 4 * batch * cfg.n_heads * seq ** 2 * cfg.head_dim_ * 0.5 * cfg.n_layers
    return 6 * n * batch * seq + attn, attn


def train_step_breakdown(trainer, state, batch, step_ms: float) -> None:
    """Where one full-width training step's device time goes: one step
    traced with ``torch.profiler``, kernels summed by name into the
    classes of ``STEP_CLASSES``; the device's idle share against the
    untraced step time ``step_ms`` (tracing slows the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer._step(state, batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    dev_ms = sum(kernels.values())
    if not dev_ms > 0:
        raise AssertionError("the profiler saw no device time")
    classes = {label: 0.0 for label, _ in STEP_CLASSES}
    classes["other"] = 0.0
    for name, t in kernels.items():
        label = next((lb for lb, rx in STEP_CLASSES if re.search(rx, name, re.I)), "other")
        classes[label] += t
    B, S = batch["tokens"].shape
    print(f"train step {TRAIN_ARCH} B={B} S={S}: device kernel time "
          f"{dev_ms:.1f} ms in one traced step (host wall {wall_ms:.1f} ms traced, "
          f"{step_ms:.1f} ms untraced: device idle {1 - dev_ms / step_ms:.1%} of the "
          f"untraced step); " + ", ".join(
              f"{label} {t:.1f} ms ({t / dev_ms:.1%})" for label, t in classes.items()))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    print("train step top kernels (ms/step): " + "; ".join(
        f"{k[:80]} {t:.2f}" for k, t in top))


def train_full() -> dict:
    """(c) ``Trainer`` trains full-width internlm2-1.8b (bf16, AdamW, seed
    0) for ``TRAIN_STEPS`` steps at B 4 x S 2048: per-step time, loss and
    ce, tokens/s, MFU (model FLOPs 6·N·T plus causal attention over 989
    TFLOP/s), memory after ``init_state`` against the state's reckoning and
    the peak; the flash kernel's main-path launches must stay 0 (training
    attention is ``blocked_attention``, as in the reference).  Then one
    ``loss_fn`` + backward unchunked and with ``seq_chunk=512`` on the
    trained state, a traced step, and the steps of
    :func:`train_reference_seq`."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import batch_to_device, make_batch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(TRAIN_ARCH)
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    trainer = Trainer(cfg, shape, tcfg=TrainerConfig(seed=0), device="cuda")
    n = cfg.param_count()
    reckoned = n * (2 + 2 + 4 + 4)          # bf16 params and grads, f32 m and v
    mem = {}
    init = trainer.init_state

    def measured_init():
        t0 = time.perf_counter()
        state = init()
        torch.cuda.synchronize()
        mem["init_s"] = time.perf_counter() - t0
        mem["state"] = torch.cuda.memory_allocated() - mem["base"]
        torch.cuda.reset_peak_memory_stats()
        return state

    trainer.init_state = measured_init
    torch.cuda.synchronize()
    mem["base"] = torch.cuda.memory_allocated()
    flash_attention_cuda.launches = 0
    window = TunerWindow()
    t0 = time.perf_counter()
    out = trainer.train(TRAIN_STEPS)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - mem["base"]
    window.report("train")
    launches = flash_attention_cuda.launches
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model_flops, attn_flops = train_model_flops(cfg, n, TRAIN_BATCH, TRAIN_SEQ)
    hist = out["history"]
    for h in hist:
        print(f"train step {h['step']}: dt {h['dt'] * 1e3:.1f} ms, loss {h['loss']:.6f}, "
              f"ce {h['ce']:.6f}, {tokens / h['dt']:.0f} tokens/s, MFU "
              f"{model_flops / (h['dt'] * BF16_FLOPS):.2%}")
    steady = statistics.median(h["dt"] for h in hist[1:])
    print(f"train {TRAIN_ARCH} full width ({n / 1e9:.4f}e9 parameters, vocab "
          f"{cfg.vocab} padded {cfg.padded_vocab()}) B={TRAIN_BATCH} S={TRAIN_SEQ} bf16 "
          f"AdamW seed 0: init_state {mem['init_s']:.1f} s, {TRAIN_STEPS} steps in "
          f"{wall:.1f} s; median step after the first {steady * 1e3:.1f} ms = "
          f"{tokens / steady:.0f} tokens/s, MFU {model_flops / (steady * BF16_FLOPS):.2%} "
          f"(model FLOPs {model_flops:.4e}/step: 6·N·T {6 * n * tokens:.4e} + causal "
          f"attention {attn_flops:.4e}); memory after init_state {mem['state'] / 1e9:.3f} "
          f"GB against {reckoned / 1e9:.3f} GB reckoned (bf16 params + bf16 grads + f32 "
          f"m, v), max_memory_allocated {peak / 1e9:.3f} GB; flash_attention main-path "
          f"launches {launches}")
    if not all(np.isfinite([h["loss"], h["ce"]]).all() for h in hist) or len(hist) != TRAIN_STEPS:
        raise AssertionError(f"training losses not finite: {hist}")
    if not abs(mem["state"] - reckoned) <= TRAIN_STATE_TOL * reckoned:
        raise AssertionError(f"state memory {mem['state']} is not {reckoned} within 2%")
    if launches != 0:
        raise AssertionError(f"the training step launched flash attention {launches} times")

    state = out["state"]
    model = state["params"]
    batch = batch_to_device(make_batch(cfg, shape, TRAIN_STEPS, 0), torch.device("cuda"))
    losses = {}
    for chunk in (None, 512):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = T.loss_fn(model, batch, cfg, seq_chunk=chunk)
        loss.backward()
        torch.cuda.synchronize()
        losses[chunk] = (loss.item(), torch.cuda.max_memory_allocated() - mem["base"])
        del loss
    gap = abs(losses[512][0] - losses[None][0]) / abs(losses[None][0])
    print(f"train loss_fn + backward on the trained state, batch of step {TRAIN_STEPS}: "
          f"unchunked loss {losses[None][0]:.6f}, peak {losses[None][1] / 1e9:.3f} GB; "
          f"seq_chunk=512 loss {losses[512][0]:.6f}, peak {losses[512][1] / 1e9:.3f} GB; "
          f"relative difference {gap:.3e} (tol {TRAIN_CHUNK_TOL})")
    if not (np.isfinite(losses[512][0]) and gap <= TRAIN_CHUNK_TOL):
        raise AssertionError("the chunked loss disagrees with the unchunked one")
    train_step_breakdown(trainer, state, batch, steady * 1e3)
    train_reference_seq(trainer, state, mem["base"])
    return {"steps": len(hist), "flash_launches": launches, "peak": peak,
            "step_ms": steady * 1e3, "first_loss": hist[0]["loss"]}


def train_reference_seq(trainer, state, base: int) -> None:
    """Steps of the trained state at the reference's training sequence
    length, B 2 x S 4096 (the same tokens a step): the tuner first, as the
    launcher does (its timing counted apart), then one warm-up step,
    ``TRAIN_REF_STEPS`` timed, the peak memory, and a traced step; the
    flash kernel's main-path launches stay 0."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import batch_to_device, make_batch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.models import transformer as T

    cfg, B, S = trainer.cfg, TRAIN_REF_BATCH, TRAIN_REF_SEQ
    shape = ShapeSpec("train_4k", S, B, "train")
    window = TunerWindow()
    T.warm_autotune(cfg, batch_size=B, seq_len=S, stages=("train",))
    window.report(f"train B={B} S={S} tuning")
    launches = flash_attention_cuda.launches
    batches = [batch_to_device(make_batch(cfg, shape, TRAIN_STEPS + 1 + i, 0),
                               torch.device("cuda")) for i in range(TRAIN_REF_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dts, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        _, metrics = trainer._step(state, batch)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated() - base
    steady = statistics.median(dts[1:])
    model_flops, attn_flops = train_model_flops(cfg, cfg.param_count(), B, S)
    print(f"train {TRAIN_ARCH} full width B={B} S={S} (the reference's train_4k sequence "
          f"length) on the trained state: steps {', '.join(f'{d * 1e3:.1f}' for d in dts)} "
          f"ms (the first a warm-up), median {steady * 1e3:.1f} ms = {B * S / steady:.0f} "
          f"tokens/s, MFU {model_flops / (steady * BF16_FLOPS):.2%} (model FLOPs "
          f"{model_flops:.4e}/step, causal attention {attn_flops:.4e}); losses "
          f"{', '.join(f'{v:.6f}' for v in losses)}; max_memory_allocated "
          f"{peak / 1e9:.3f} GB; flash_attention main-path launches "
          f"{flash_attention_cuda.launches - launches}")
    if not (np.isfinite(losses).all() and flash_attention_cuda.launches == launches):
        raise AssertionError(f"S={S} steps: losses {losses}, flash launches "
                             f"{flash_attention_cuda.launches - launches}")
    train_step_breakdown(trainer, state, batches[-1], steady * 1e3)


def train_checkpoint_check() -> None:
    """(d) A checkpoint of reduced internlm2-1.8b saved on the card by the
    ``Trainer`` after two steps and restored by a fresh one: every leaf
    (bf16 parameters, f32 m and v, int32 step) equal bit for bit."""
    import tempfile

    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import train_state_to_tree
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(TRAIN_ARCH, reduced=True)
    shape = ShapeSpec("ck", 64, 2, "train")
    root = ROOT / "build" / "repro_torch"
    root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as d:
        tcfg = TrainerConfig(ckpt_dir=d, ckpt_every=100, grad_compression=0.25)
        out = Trainer(cfg, shape, tcfg=tcfg, device="cuda").train(2)
        start, restored = Trainer(cfg, shape, tcfg=tcfg, device="cuda").restore_or_init()
        saved = train_state_to_tree(out["state"], cfg)
        back = train_state_to_tree(restored, cfg)
    saved, back = flat_leaves(saved), flat_leaves(back)
    leaves = {k: sorted(saved) == sorted(back) and t.dtype == back[k].dtype
              and torch.equal(t, back[k]) for k, t in saved.items()}
    on_card = next(restored["params"].parameters()).device
    print(f"train checkpoint reduced {TRAIN_ARCH} (gradient compression on), saved on "
          f"the card after 2 steps, restored at step {start} on {on_card}: "
          f"{sum(leaves.values())}/{len(leaves)} leaves equal bit for bit")
    if not (start == 2 and on_card.type == "cuda" and all(leaves.values())):
        raise AssertionError(f"checkpoint round trip not exact: "
                             f"{[k for k, ok in leaves.items() if not ok]}")


def train_phase() -> dict:
    import gc

    import torch

    t0 = time.perf_counter()
    train_grad_check()
    tuned = train_tune_check()
    full = train_full()
    gc.collect()
    torch.cuda.empty_cache()
    train_checkpoint_check()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train phase done in {time.perf_counter() - t0:.1f} s; memory_allocated "
          f"after {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    return {**tuned, **full}


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
    q_offset 1024, decode (Sq = 1), S = 384, head dims 64 and 32 (each head
    dim is its own tensor-core instantiation), in both types, and fully
    masked rows, also with a ragged last K/V tile (Sk = 200); then kernel,
    plain version and ``scaled_dot_product_attention`` timed at the prefill
    shape, in bf16 and in f32."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    B, H, Hkv, S, Dh = TUNE_BATCH, 32, 8, TUNE_SEQ, 128
    pre, dec = tuned["flash_prefill"], tuned["flash_decode"]
    err, (q, k, v, _) = flash_check(gen, "qwen3-4b prefill (tuned)", B, H, Hkv, S, S,
                                    Dh, torch.bfloat16, **pre)
    f32_err, _ = flash_check(gen, "qwen3-4b prefill (tuned for f32)", B, H, Hkv, S, S, Dh,
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
    # the f32 (3xTF32) kernel at the bf16 checks' other edges, drawn after
    # them so that their inputs stay as they were: decode (one query row, 15
    # of its warp's 16 fragment rows idle), the chunk at q_offset 1024, Dh 32
    f32_err = max(f32_err,
                  flash_check(gen, "decode (tuned)", B, H, Hkv, 1, S, Dh, torch.float32,
                              q_offset=S - 1, **dec)[0],
                  flash_check(gen, "512-query chunk", B, H, Hkv, 512, S, Dh, torch.float32,
                              q_offset=1024)[0],
                  flash_check(gen, "Dh=32", 2, 8, 2, 256, 256, 32, torch.float32,
                              block_q=128, block_k=64)[0])

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
    # f32 at the same shape: the 3xTF32 kernel at its tuned config, the plain
    # version and SDPA in f32 (matmul TF32 is off for the whole script), on
    # the same values upcast; the kernel's error is gated by the f32 checks
    # above.  Two bounds: the f32 work on the CUDA cores (67 TFLOP/s) and
    # three TF32 products for each f32 one on the tensor cores (495)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    kr32, vr32 = (t.repeat_interleave(H // Hkv, dim=1) for t in (k32, v32))
    cfg32 = tuned["flash_prefill_f32"]
    f32_lib_err = float((F.scaled_dot_product_attention(q32, kr32, vr32, is_causal=True)
                         - attention_ref(q32, k32, v32)).abs().max())
    f32_ms = time_ms(lambda: flash_attention_cuda(q32, k32, v32, **cfg32), flush, 10, 2)
    f32_plain_ms = time_ms(lambda: attention_ref(q32, k32, v32), flush, 5, 1)
    f32_library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q32, kr32, vr32, is_causal=True), flush, 10, 2)
    f32_ms_again = time_ms(lambda: flash_attention_cuda(q32, k32, v32, **cfg32), flush, 10, 2)
    t_ops32, t_bytes32 = flops / F32_FLOPS, 2 * nbytes / HBM_BYTES_PER_S
    f32_bound_ms = max(t_ops32, t_bytes32) * 1e3
    t_tc32 = 3 * flops / TF32_FLOPS
    f32_bound_tc_ms = max(t_tc32, t_bytes32) * 1e3
    print(f"timing flash_attention qwen3-4b prefill B={B} H={H} Hkv={Hkv} S={S} Dh={Dh} f32 "
          f"causal at {cfg32}: kernel {f32_ms:.4f} / {f32_ms_again:.4f} ms "
          f"({flops / f32_ms / 1e9:.1f} TFLOP/s), plain {f32_plain_ms:.4f} ms, "
          f"scaled_dot_product_attention f32 {f32_library_ms:.4f} ms "
          f"({f32_ms / f32_library_ms:.2f}x; its max_abs_err vs plain {f32_lib_err:.3e}, the "
          f"kernel's {f32_err:.3e}); bound {f32_bound_tc_ms:.4f} ms "
          f"({'operations' if t_tc32 >= t_bytes32 else 'bytes'}, 3xTF32 on the tensor cores) -> "
          f"{f32_bound_tc_ms / f32_ms:.1%} of bound; {f32_bound_ms:.4f} ms "
          f"({'operations' if t_ops32 >= t_bytes32 else 'bytes'}, CUDA-core f32) -> "
          f"{f32_bound_ms / f32_ms:.1%}")
    del q32, k32, v32, kr32, vr32
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "f32_max_abs_err": f32_err, "f32_ms": f32_ms, "f32_plain_ms": f32_plain_ms,
            "f32_library_ms": f32_library_ms, "f32_library_max_abs_err": f32_lib_err,
            "f32_bound_ms": f32_bound_ms, "f32_bound_tc_ms": f32_bound_tc_ms}


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


def conv_bound(N, H, W, C, K, O, stride, pad, dtype="float32",
               tc: bool = False) -> tuple[float, str]:
    """(bound ms, what bounds it): x and w read once and y written once, in
    ``dtype``, against 2·N·OH·OW·K·K·C·O flops at that type's peak: f32 on
    the CUDA cores (67 TFLOP/s; the retired f32 kernel's), bf16 on the
    tensor cores (the bf16 kernel's); with ``tc``, f32 as three TF32
    products an f32 one on the tensor cores (3 × flops at 495 TFLOP/s),
    the f32 kernel's way to f32 accuracy."""
    OH, OW = 1 + (H + 2 * pad - K) // stride, 1 + (W + 2 * pad - K) // stride
    itemsize, peak = (2, BF16_FLOPS) if dtype == "bfloat16" else (4, F32_FLOPS)
    if tc and dtype == "float32":
        peak = TF32_FLOPS / 3
    nbytes = itemsize * (N * H * W * C + K * K * C * O + N * OH * OW * O)
    flops = 2 * N * OH * OW * K * K * C * O
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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


def topology_pairs(models, batch_sizes) -> set:
    """Distinct (batch size, H, W, C, K, O, stride, padding) over the
    groups = 1 convolutions of ``models``, each at every batch size: the
    shapes a profile of those topologies gives the kernel."""
    return {(bs, *conv_shape(*c)) for m in models for c in conv_nodes(m)
            for bs in batch_sizes}


def check_conv_pairs(pairs, label: str, seed: int) -> float:
    """``conv_check`` in f32 at every pair of ``topology_pairs``, on inputs
    drawn from ``seed``; prints one line and returns the max abs error.
    Call it after the main path's count is read: these launches are not
    the main path's."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    err = 0.0
    for N, H, W, C, K, O, s, p in sorted(pairs):
        x, w = conv_inputs(gen, N, H, W, C, K, O, torch.float32)
        err = max(err, conv_check(x, w, s, p))
    del x, w
    print(f"kernel conv_mm {label}: {len(pairs)} distinct (batch size, convolution) "
          f"pairs float32: max_abs_err={err:.3e} (rtol {CONV_TOL['float32'][0]}, atol "
          f"{CONV_TOL['float32'][1]}) in {time.perf_counter() - t0:.1f} s")
    return err


# kernel_bench's conv_mm shape (the reference's): (N, H, W, C, K, O, stride,
# padding), bf16
CONV_BENCH = (8, 32, 32, 128, 3, 128, 1, 1)


def conv_kernel_phase(flush) -> dict:
    """conv_mm against its plain version on every distinct convolution
    shape of full-width ResNet-50 (bs 32) and on the edge cases, f32 and
    bf16, and at the kernel bench's bf16 shape; then times at bs 128, each
    shape first held against the plain version, f32 and bf16: three named
    shapes, and the sum over the 53 convolutions of one forward pass; and
    the bench shape in bf16.  Beside the kernel: its plain version,
    ``F.conv2d`` on channels-last views of the same tensors (cuDNN, no
    TF32; the yardstick, never called by the port) and the bound."""
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
        lib_err = float((F.conv2d(xc, wc, stride=s, padding=p).permute(0, 2, 3, 1).float()
                         - conv_ref(x, w, stride=s, padding=p).float()).abs().max())
        return (time_ms(lambda: conv_mm_cuda(x, w, stride=s, padding=p), flush, reps, warmup),
                time_ms(lambda: conv_ref(x, w, stride=s, padding=p), flush, reps, warmup),
                time_ms(lambda: F.conv2d(xc, wc, stride=s, padding=p), flush, reps, warmup),
                lib_err)

    types = (("float32", torch.float32, "f32"), ("bfloat16", torch.bfloat16, "bf16"))
    for label, (H, W, C, K, O, s, p) in (
            ("largest 3x3", (32, 32, 64, 3, 64, 1, 1)),
            ("largest 1x1", (4, 4, 512, 1, 2048, 1, 0)),
            ("stem", (32, 32, 3, 3, 64, 1, 1))):
        for name, dtype, short in types:
            x, w = conv_inputs(gen, 128, H, W, C, K, O, dtype)
            ms, plain, lib, lib_err = three(x, w, s, p)
            bound_ms, by = conv_bound(128, H, W, C, K, O, s, p, name)
            tc_ms, tc_by = conv_bound(128, H, W, C, K, O, s, p, name, tc=True)
            ceiling = (f" on the CUDA cores; 3xTF32 bound {tc_ms:.4f} ms ({tc_by}) -> "
                       f"{tc_ms / ms:.1%} of it" if name == "float32" else "")
            print(f"timing conv_mm {label} N=128 {H}x{W} C={C} K={K} O={O} s={s} p={p} "
                  f"{short}: kernel {ms:.4f} ms, plain {plain:.4f} ms, F.conv2d (cuDNN, "
                  f"no TF32) {lib:.4f} ms (max_abs_err vs plain {lib_err:.3e}), bound "
                  f"{bound_ms:.4f} ms ({by}) -> {bound_ms / ms:.1%} of bound{ceiling}")

    # f32: the kernel's bound is three TF32 products an f32 one on the
    # tensor cores (the line's bound_ms); the f32 work on the CUDA cores,
    # the retired kernel's bound, is printed and kept beside it
    out: dict = {}
    for name, dtype, short in types:
        total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        by_ops = by_bytes = core_ms = 0.0
        for (H, W, C, K, O, s, p), n in counts.items():
            x, w = conv_inputs(gen, 128, H, W, C, K, O, dtype)
            conv_check(x, w, s, p)
            ms, plain, lib, _ = three(x, w, s, p, reps=10, warmup=2)
            core, _ = conv_bound(128, H, W, C, K, O, s, p, name)
            bound_ms, by = conv_bound(128, H, W, C, K, O, s, p, name, tc=name == "float32")
            for key, v in zip(total, (ms, plain, lib, bound_ms)):
                total[key] += n * v
            core_ms += n * core
            by_ops += n * bound_ms if by == "operations" else 0.0
            by_bytes += n * bound_ms if by == "bytes" else 0.0
        total["bound_by"] = "operations" if by_ops >= by_bytes else "bytes"
        cores = (f"; on the CUDA cores {core_ms:.3f} ms -> {core_ms / total['ms']:.1%} of it"
                 if name == "float32" else "")
        print(f"timing conv_mm all {len(convs)} convolutions of one ResNet-50 forward, "
              f"N=128 32x32 {short}: kernel {total['ms']:.3f} ms, plain "
              f"{total['plain_ms']:.3f} ms, F.conv2d (cuDNN, no TF32) "
              f"{total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms"
              f"{' (3xTF32)' if name == 'float32' else ''} ({by_ops:.3f} ms of it bound by "
              f"operations, {by_bytes:.3f} ms by bytes) -> "
              f"{total['bound_ms'] / total['ms']:.1%} of bound{cores}")
        # f32's numbers are the line's unprefixed keys (the main path's type)
        if name == "float32":
            out.update(total, cuda_core_bound_ms=core_ms)
        else:
            out.update({f"bf16_forward_{k}": v for k, v in total.items()})

    N, H, W, C, K, O, s, p = CONV_BENCH
    x, w = conv_inputs(gen, N, H, W, C, K, O, torch.bfloat16)
    err = conv_check(x, w, s, p)
    ms, plain, lib, lib_err = three(x, w, s, p)
    bound_ms, by = conv_bound(N, H, W, C, K, O, s, p, "bfloat16")
    print(f"timing conv_mm bench shape N={N} {H}x{W} C={C} K={K} O={O} s={s} p={p} bf16: "
          f"max_abs_err vs plain {err:.3e}; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"F.conv2d (cuDNN) {lib:.4f} ms (max_abs_err vs plain {lib_err:.3e}), bound "
          f"{bound_ms:.4f} ms ({by}) -> {bound_ms / ms:.1%} of bound")
    out.update({"bf16_bench_max_abs_err": err, "bf16_bench_ms": ms,
                "bf16_bench_plain_ms": plain, "bf16_bench_library_ms": lib,
                "bf16_bench_bound_ms": bound_ms, "bf16_bench_bound_by": by})
    return out


def cnn_step_check(seed: int = 0) -> dict:
    """One SGD-momentum step of a reduced ResNet-50 (width 0.25, 16x16,
    bs 8, weights and batch from ``seed``, zero momentum) on the card (the
    kernel, cuDNN backward)
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
    forward's summation order.  Returns the card's relative errors by
    part; raises where one is over its tolerance."""
    import torch

    from repro_torch.convert import cnn_params_from_numpy, tree_leaves, tree_map
    from repro_torch.core.profiler import make_train_step
    from repro_torch.kernels.conv_mm import ops
    from repro_torch.kernels.conv_mm.ref import conv_ref
    from repro_torch.models.cnn import build_resnet50

    model = build_resnet50(width_mult=0.25, input_hw=16)
    init = model.init(seed)
    rng = np.random.default_rng(seed)
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
    print(f"cnn step reduced ResNet-50 (width 0.25, 16x16, bs 8, seed {seed}), relative "
          "error against the float64 step: " + "; ".join(
              f"{part} card {rel('card', part):.3e} / card with the plain forward "
              f"{rel('card, plain forward', part):.3e} / CPU {rel('cpu', part):.3e} "
              f"(tol {tol:.3e})" for part, tol in tols.items()))
    for part, tol in tols.items():
        if not rel("card", part) <= tol:
            raise AssertionError(f"card step {part} off the exact step: {rel('card', part):.3e}")
    return {part: rel("card", part) for part in tols}


def cnn_toolflow(repeats: int = 5, warmup: int = 2) -> dict:
    """Full-width ResNet-50 through the paper's toolflow on the card:
    prune, profile Γ/Φ per (level, batch size), cache, fit, predict."""
    import torch

    from repro_torch.bench.common import GRID_BS
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
    topologies = {(name, lv): _build_pruned(spec, lv)
                  for name, spec in grids.items() for lv in spec.levels}
    n_convs = {key: len(conv_nodes(m)) for key, m in topologies.items()}
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
    err = check_conv_pairs(topology_pairs(topologies.values(), GRID_BS),
                           f"every shape of the grid, {len(topologies)} topologies", 1)
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


def cnn_phase() -> dict:
    t0 = time.perf_counter()
    cnn_step_check()
    result = cnn_toolflow()
    print(f"cnn phase done in {time.perf_counter() - t0:.1f} s")
    return result


# ---------------------------------------------------------------------------
# The cost engine, calibration and the §6.4 evolutionary search
# ---------------------------------------------------------------------------

# The Table 2 runner's protocol (repro_torch.bench.table2_case_study) at
# full width: sub-networks sampled from seeds 2000 + i, N_TRAIN_SUB to fit
# the inference forest and N_TEST_SUB to test it, profiled for inference at
# INFER_BS and once for training at the search's batch size; the reference
# runner's search size (the paper's is population 100 x 500 iterations).
# Every profile of the phase (sub-networks, winners) takes the median of
# 10 steps after 2 warm-up steps: more than the reference runner's
# profiler defaults (3 and 1 for inference, 2 and 1 for training), since
# φ at bs 1 on the card is host time.  A profile runs
# 2 + warmup + repeats steps, each launching conv_mm once per groups = 1
# convolution.
PROFILE = dict(repeats=10, warmup=2)
PROFILE_STEPS = 2 + PROFILE["warmup"] + PROFILE["repeats"]


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

    from repro_torch.bench.table2_case_study import (INFER_BS, N_TEST_SUB, N_TRAIN_SUB,
                                                     SEARCH, SEARCH_INFER_BS, budget_tiers)
    from repro_torch.bench.table2_case_study import TRAIN_BS as SEARCH_TRAIN_BS
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
    tiers = {"MAX": Constraints(train_bs=SEARCH_TRAIN_BS, infer_bs=SEARCH_INFER_BS)}
    tier_notes = {"MAX": "no budget"}
    measured = np.array([[r["gamma"] for r in train_rows],
                         [r["gamma"] for r in infer_rows if r["bs"] == SEARCH_INFER_BS],
                         [r["phi"] for r in infer_rows if r["bs"] == SEARCH_INFER_BS]])
    # the Table 2 runner's budget rule: per metric the larger of a quantile of
    # the measurements and of the engine's predicted first population, raised
    # until 4 first candidates are feasible, B inside A
    budgeted, notes, best_first, pred = budget_tiers(engine.estimate, measured,
                                                     width_mult=wm, input_hw=hw)
    tiers.update(budgeted)
    tier_notes.update(notes)
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

    # 4. each winner measured through the engine: model-only queries fall
    # through forest and analytical to the profiler (a winner met again, as
    # two tiers' may be, is a hit on its measurement and profiles nothing)
    for name, r in results.items():
        tier = tiers[name]
        m = build_resnet50(widths=r.widths, input_hw=hw)
        qs = [CostQuery(model=m, bs=tier.train_bs, stage="train"),
              CostQuery(model=m, bs=tier.infer_bs, stage="infer")]
        est_t, est_i = engine.estimate(qs)
        for e in (est_t, est_i):
            if e.source != "profiler":
                raise AssertionError(f"tier {name} winner answered by {e.source}")
            positive(f"tier {name} winner measured", e.gamma_mb, e.phi_ms)
            if not e.detail.get("cached"):
                expected += len(conv_nodes(m)) * PROFILE_STEPS
        meets = not (
            (tier.gamma_mb is not None and est_t.gamma_mb > tier.gamma_mb)
            or (tier.gamma_inf_mb is not None and est_i.gamma_mb > tier.gamma_inf_mb)
            or (tier.phi_inf_ms is not None and est_i.phi_ms > tier.phi_inf_ms))
        print(f"engine tier {name} winner measured through the engine (source "
              f"{est_t.source}, cached {bool(est_t.detail.get('cached'))}): "
              f"Γ {est_t.gamma_mb:.2f} MB (predicted {r.gamma_mb:.2f}), "
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


# ---------------------------------------------------------------------------
# The paper's benchmark runners
# ---------------------------------------------------------------------------

def bench_phase(cnn: dict) -> dict:
    """Two of the paper runners (``repro_torch.bench``) at full width on the
    card: §6.2.1's DNNMem comparison over the cnn phase's cache, which
    holds every point it reads (0 profiled, 0 ``conv_mm`` launches), and
    §6.2's strategy variation on a fresh cache, which profiles the
    MobileNetV2 train grid and its 8 strategies.  Each runner reads its
    own datapoints profiled and ``conv_mm`` launches around its work and
    prints them on its ``<name>/card_s`` line; the phase gates on that
    line.  Then ``conv_mm`` is held against its plain version at every
    (batch size, shape) the strategies run gave it, and at every one that
    the paper set (``bench.run``) gives it: each topology of
    ``collect_cnn_data.all_grids`` at its batch sizes, seven families."""
    import torch

    from repro_torch.bench import common, dnnmem_comparison, strategy_variation
    from repro_torch.bench.collect_cnn_data import all_grids
    from repro_torch.core.dataset import DEFAULT_TRAIN_LEVELS, GridSpec, _build_pruned
    from repro_torch.kernels.conv_mm.kernel import conv_mm_cuda

    geo = common.FULL
    steps = 2 + geo.warmup + geo.repeats          # profile_training's steps a profile
    t0 = time.perf_counter()
    lines: list[str] = []

    def out(line: str) -> None:
        print(f"bench {line}")
        lines.append(line)

    def tally(name: str) -> tuple[int, int]:
        """(datapoints profiled, conv_mm launches) of ``<name>/card_s``."""
        line = next(ln for ln in lines if ln.startswith(f"{name}/card_s,"))
        fields = dict(f.split("=") for f in line.split(",", 2)[2].split())
        return int(fields["profiled"]), int(fields["conv_mm_launches"])

    torch.cuda.synchronize()
    conv_mm_cuda.launches = 0
    err = dnnmem_comparison.run(out, cache_path=cnn["cache"], geometry=geo)
    profiled, launches = tally("dnnmem")
    print(f"bench dnnmem over the cnn phase's cache {Path(cnn['cache']).relative_to(ROOT)}: "
          f"profiled {profiled}, conv_mm launches {launches} (both must be 0)")
    if profiled or launches:
        raise AssertionError("dnnmem must run from the cnn phase's cache")
    positive("dnnmem Γ error", err)

    path = ROOT / "build" / "repro_torch" / "bench_strategies.json"
    path.unlink(missing_ok=True)          # a fresh cache: every point is profiled
    grid = GridSpec("mobilenetv2", DEFAULT_TRAIN_LEVELS, "random", geo.batch_sizes,
                    geo.width_mult, geo.input_hw)
    grid_models = [_build_pruned(grid, lv) for lv in grid.levels]
    models = strategy_variation.strategy_models(geo)
    expected = steps * (len(geo.batch_sizes) * sum(len(conv_nodes(m)) for m in grid_models)
                        + sum(len(conv_nodes(m)) for m in models))
    n_points = len(grid.levels) * len(geo.batch_sizes) + len(models)
    torch.cuda.synchronize()
    conv_mm_cuda.launches = 0
    window = TunerWindow()
    res = strategy_variation.run(out, cache_path=str(path), geometry=geo)
    profiled, launches = tally("strategies")
    window.report("bench strategies")
    print(f"bench strategies MobileNetV2 width {geo.width_mult} {geo.input_hw}x"
          f"{geo.input_hw}: {profiled} datapoints profiled (expected {n_points}: the "
          f"train grid, {len(grid.levels)} levels x batch sizes {list(geo.batch_sizes)}, "
          f"and {len(models)} strategies at bs {strategy_variation.BS}); conv_mm "
          f"launches={launches} (expected {expected} = sum of groups=1 convolutions over "
          f"the profiled topologies x profiles x {steps} steps)")
    if profiled != n_points or launches != expected:
        raise AssertionError(f"strategies: {profiled} datapoints, {launches} conv_mm "
                             f"launches; expected {n_points} and {expected}")
    positive("strategies results", *res.values())
    for key, dp in json.loads(path.read_text()).items():
        positive(f"strategies datapoint {key}", dp["gamma_mb"], dp["phi_ms"])
        if len(dp["features"]) != 42:
            raise AssertionError(f"strategies datapoint {key} has no features")

    # the kernel against its plain version at the shapes of this slice's path
    pairs = (topology_pairs(grid_models, geo.batch_sizes)
             | topology_pairs(models, (strategy_variation.BS,)))
    worst = check_conv_pairs(pairs, "every shape of the strategies run", 2)
    paper: dict = {}
    for g in all_grids(geo):
        paper.setdefault(g.family, set()).update(
            topology_pairs([_build_pruned(g, lv) for lv in g.levels], g.batch_sizes))
    print("bench paper set: distinct (batch size, convolution) pairs per family: "
          + ", ".join(f"{f} {len(v)}" for f, v in paper.items()))
    worst = max(worst, check_conv_pairs(set().union(*paper.values()),
                                        f"every shape of the paper set, {len(paper)} "
                                        "families", 3))
    print(f"bench phase done in {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "max_abs_err": worst}


# ---------------------------------------------------------------------------
# The auto-sharding planner, the launcher's --auto-mesh, and the serving,
# kernel and engine benches (repro_torch.planner, repro_torch.bench)
# ---------------------------------------------------------------------------

PLAN_ARCH, PLAN_BATCH, PLAN_SEQ = "internlm2-1.8b", 4, 2048
PLAN_DEVICES = (1, 2, 4, 8)
# the launcher's first loss against the train phase's: the same seed-0
# parameters and batch through the same kernels on one card, so the same
# f32 loss up to a rounding
LAUNCH_LOSS_RTOL = 1e-6
SERVE_SPEEDUP_MIN = 1.0                  # the reference's check_thresholds gates
# passes of serve_bench.run on the same weights: its two host-clock gates
# (continuous req/s and goodput against lockstep's) read the median pass
SERVE_RUN_PASSES = 3
# measured passes of serve_bench.run_chunked a mode (the bench's own
# CHUNK_REPEATS is 3): every condition it gates is a step count, the same on
# each pass, and only its wall-clock ratios, which it reports, pool passes
SERVE_CHUNK_REPEATS = 1
CHUNKED_TTFT_STEPS_RATIO_MAX = 1.10
CHAOS_GOODPUT_RATIO_MIN = 0.25
ENGINE_PARITY_TOL = 1e-9
LEDGER_PARITY_RTOL = 1e-9
PLANNER_WALL_S_MAX = 1.0


def benches_planner(trained: dict) -> dict:
    """(a) Full-width internlm2-1.8b, train B 4 x S 2048, planned over 1, 2,
    4 and 8 devices through ``LayoutPlanner(CostEngine(EnsembleBackend(
    [AnalyticalBackend(lm_device=<this card>)])))``: one meta trace for the
    base, every later query a cache hit, no kernel launched and nothing
    allocated; 1x1x1's Φ is the base, 1x8x1 is refused for batch
    divisibility; collectives priced from the spec's data-sheet ``ici_bw``
    (no campaign cell measured a collective)."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.engine import (AnalyticalBackend, CostEngine, EnsembleBackend,
                                    from_torch_device)
    from repro_torch.planner import LayoutPlanner

    spec = from_torch_device()
    backend = AnalyticalBackend(lm_device=spec)
    cache = ROOT / "build" / "repro_torch" / "benches_planner_estimates.json"
    cache.unlink(missing_ok=True)
    engine = CostEngine(EnsembleBackend([backend]), cache=str(cache), device=spec)
    planner = LayoutPlanner(engine, reduced=False)
    shape = ShapeSpec("train_b4_s2048", PLAN_SEQ, PLAN_BATCH, "train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts, alloc = kernel_counts(), torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    plans, walls = {}, {}
    for n in PLAN_DEVICES:
        t0 = time.perf_counter()
        plans[n] = planner.plan(PLAN_ARCH, shape, n)
        walls[n] = time.perf_counter() - t0
        print(f"benches planner {PLAN_ARCH} B={PLAN_BATCH} S={PLAN_SEQ} over {n} "
              f"device(s) in {walls[n]:.3f} s:")
        for line in plans[n].table(top=None).splitlines():
            print(f"benches   {line}")
    torch.cuda.synchronize()
    if kernel_counts() != counts or torch.cuda.memory_allocated() != alloc \
            or torch.cuda.max_memory_allocated() != peak:
        raise AssertionError("planning launched a kernel or allocated on the card: "
                             f"{counts} -> {kernel_counts()}, {alloc} -> "
                             f"{torch.cuda.memory_allocated()} bytes")
    print(f"benches planner engine: {backend.traces} trace(s) in "
          f"{backend.trace_seconds:.2f} s, engine hits {engine.hits}, misses "
          f"{engine.misses}; kernel launches and memory unchanged")
    if backend.traces != 1 or engine.hits != len(PLAN_DEVICES) - 1:
        raise AssertionError(f"the base must be one trace and every later query a "
                             f"cache hit: traces {backend.traces}, hits {engine.hits}")
    one = plans[1].decision_for("1x1x1")
    base = plans[1].base
    if one is None or one.phi_ms != base["phi_ms"] or one.gamma_mb != base["gamma_mb"]:
        raise AssertionError(f"1x1x1 is not the base: {one} against {base}")
    refused = {r.layout.descriptor: r.reason for r in plans[8].refused}
    if "not divisible" not in refused.get("1x8x1", ""):
        raise AssertionError(f"1x8x1 must be refused for batch divisibility: {refused}")
    fitted = any(p.meta["collective_coeff_fitted"] for p in plans.values())
    print(f"benches planner collectives priced from {spec.name}'s ici_bw "
          f"{spec.ici_bw / 1e9:.0f} GB/s (data sheet, one NVLink direction): "
          f"collective coefficient fitted {fitted}; no campaign cell measured a "
          f"collective (one card)")
    if fitted:
        raise AssertionError("a collective coefficient was fitted without a measurement")
    print(f"benches planner 1x1x1: Φ {one.phi_ms:.2f} ms, Γ {one.gamma_mb / 1e3:.3f} GB "
          f"against the train phase's median step {trained['step_ms']:.1f} ms and peak "
          f"{trained['peak'] / 1e9:.3f} GB; chosen per count: " + ", ".join(
              f"{n}: {p.chosen.layout.descriptor} Φ {p.chosen.phi_ms:.2f} ms Γ "
              f"{p.chosen.gamma_mb / 1e3:.3f} GB" for n, p in plans.items()))
    return {"plans": plans, "walls": walls}


def benches_planner_bench() -> dict:
    """(b) ``engine_bench.planner_bench()`` as the reference runs it: 256
    ``tpu_v5e`` devices, a planted forest, the analytical trace trapped."""
    from repro_torch.bench import engine_bench

    out = engine_bench.planner_bench(lambda line: print(f"benches {line}"))
    if out["compiles"] != 0 or not out["chosen_phi_ms"] <= out["default_phi_ms"] \
            or not out["wall_s"] < PLANNER_WALL_S_MAX:
        raise AssertionError(f"planner_bench: {out}")
    return out


def benches_launcher(trained: dict) -> dict:
    """(c) The launcher with ``--auto-mesh 4 --n-micro 8`` on the h100 spec:
    the plan printed, the one-card line, one step unsharded; its first loss
    against the train phase's (same seed-0 parameters, same batch)."""
    import contextlib
    import gc
    import io

    import torch

    from repro_torch.launch import train as launch

    argv = ["--arch", PLAN_ARCH, "--batch", str(PLAN_BATCH), "--seq", str(PLAN_SEQ),
            "--steps", "1", "--device", "h100", "--auto-mesh", "4", "--n-micro", "8"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        summary = launch.main(argv)
    secs = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"benches launcher | {line}")
    gc.collect()
    torch.cuda.empty_cache()
    gap = abs(summary["first_loss"] - trained["first_loss"]) / abs(trained["first_loss"])
    print(f"benches launcher {' '.join(argv)}: {secs:.1f} s; first loss "
          f"{summary['first_loss']:.6f} against the train phase's "
          f"{trained['first_loss']:.6f}: relative difference {gap:.3e} (tol "
          f"{LAUNCH_LOSS_RTOL})")
    if "phi_ms" not in text or "needs 4 devices, host has 1 — plan reported, " \
            "training unsharded" not in text:
        raise AssertionError("the launcher did not print the plan and the one-card line")
    if summary["steps"] != 1 or not gap <= LAUNCH_LOSS_RTOL:
        raise AssertionError(f"the launcher's step disagrees: {summary}")
    return {"seconds": secs, "gap": gap}


def benches_serve(drawing) -> dict:
    """(d) ``serve_bench`` at full width: internlm2-1.8b (24 layers, bf16,
    seed 0; ``drawing``, a :func:`host_draw` started with the phase, so
    that it runs beside the planner and the launcher) drawn once and
    passed to ``run``, ``run_chunked`` (``SERVE_CHUNK_REPEATS`` measured
    passes a mode) and ``run_chaos``; paged-decode launches counted around each and held to
    the continuous engines' decode steps x layers (the tuner's counted
    apart); the reference's threshold conditions, all gated; the kernel
    against its plain version on the served pool."""
    import gc

    import torch

    from repro_torch.bench import serve_bench
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.paged_decode import ops
    from repro_torch.kernels.paged_decode.kernel import paged_decode_cuda
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref

    cfg = get_config(PLAN_ARCH)
    t0 = time.perf_counter()
    params, draw_s = drawing.result()
    params = params.to("cuda")
    torch.cuda.synchronize()
    print(f"benches serve init_params({PLAN_ARCH}, seed=0): {cfg.n_layers} layers, "
          f"{cfg.param_count() / 1e9:.4f}e9 parameters, bf16, drawn on the host in "
          f"{draw_s:.1f} s beside the planner and the launcher, on the card "
          f"{time.perf_counter() - t0:.1f} s after them")
    Path(serve_bench.TUNING_CACHE).unlink(missing_ok=True)
    last, launch = {}, ops.paged_decode_cuda

    def keep_last(*args, **kw):    # the served model's own kernel inputs
        last["args"], last["kw"] = args, kw
        return launch(*args, **kw)

    def run_chunked(*args, **kw):
        repeats, serve_bench.CHUNK_REPEATS = serve_bench.CHUNK_REPEATS, SERVE_CHUNK_REPEATS
        try:
            return serve_bench.run_chunked(*args, **kw)
        finally:
            serve_bench.CHUNK_REPEATS = repeats

    results, launches, secs = {}, {}, {}
    runs = [f"run {i + 1}" for i in range(SERVE_RUN_PASSES)]
    ops.paged_decode_cuda = keep_last
    try:
        for name, fn in ([(r, serve_bench.run) for r in runs]
                         + [("chunked", run_chunked),
                            ("chaos", serve_bench.run_chaos)]):
            torch.cuda.synchronize()
            paged_decode_cuda.launches = 0
            window = TunerWindow()
            t0 = time.perf_counter()
            results[name] = fn(lambda line: print(f"benches {line}"), device="cuda",
                               cfg=cfg, params=params)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            launches[name] = paged_decode_cuda.launches
            window.report(f"benches serve_bench {name}")
            steps = results[name]["decode_steps_total"]
            print(f"benches serve_bench {name}: {secs[name]:.1f} s, paged_decode "
                  f"launches {launches[name]} (decode steps {steps} x {cfg.n_layers} = "
                  f"{steps * cfg.n_layers})")
            if not launches[name] == steps * cfg.n_layers > 0:
                raise AssertionError(f"serve_bench {name}: {launches[name]} launches, "
                                     f"{steps} decode steps")
    finally:
        ops.paged_decode_cuda = launch

    for r in runs:
        s = results[r]
        print(f"benches serve_bench {r}: lockstep {s['lockstep_rps']:.3f} req/s, continuous "
              f"{s['continuous_rps']:.3f} req/s ({s['speedup']:.2f}x), goodput "
              f"{s['goodput_lockstep']:.3f} / {s['goodput_continuous']:.3f} req/s")
    # each host-clock condition reads its median pass: the record gated
    # below and handed on to check_thresholds is the pass of median speedup,
    # its goodput pair that of the pass of median goodput gain
    def median_pass(key):
        return sorted((results[r] for r in runs), key=key)[SERVE_RUN_PASSES // 2]

    by_goodput = median_pass(lambda s: s["goodput_continuous"] - s["goodput_lockstep"])
    srv = dict(median_pass(lambda s: s["speedup"]),
               goodput_lockstep=by_goodput["goodput_lockstep"],
               goodput_continuous=by_goodput["goodput_continuous"])
    results["run"] = srv
    print(f"benches serve_bench run over {SERVE_RUN_PASSES} passes: median speedup "
          f"{srv['speedup']:.2f}x, median goodput continuous - lockstep "
          f"{srv['goodput_continuous'] - srv['goodput_lockstep']:.3f} req/s; passes "
          f"2-{SERVE_RUN_PASSES} added {sum(secs[r] for r in runs[1:]):.1f} s")
    chk, chaos = results["chunked"], results["chaos"]
    # At max_len 64 and 128 the card tuner picks a block of the whole
    # window: ``run``'s engine fits it to the pool (serve.kv_cache.
    # fit_block_size; else 2 blocks for 4 slots), and the chunked row keeps
    # it (its engines compare streams) while the engine prefills a short
    # prompt at 16 tokens, not the block (else a stall of 128).
    gates = {
        "a pool block for every slot": srv["usable_blocks"] >= serve_bench.N_SLOTS,
        "continuous req/s >= lockstep (median pass)": srv["speedup"] >= SERVE_SPEEDUP_MIN,
        "goodput continuous >= lockstep (median pass)": (srv["goodput_continuous"]
                                                         >= srv["goodput_lockstep"]),
        "finite percentiles": all(np.isfinite(srv[k]) and srv[k] > 0 for k in
                                  ("ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms",
                                   "tpot_p99_ms")),
        "paged pool < dense cache": srv["kv_bytes"] < srv["kv_dense_bytes"],
        "chunked streams equal": chk["streams_equal"],
        "chunked prefill chunked": chk["chunked"]["prefill_chunks"] > 0,
        "no decode stall": chk["chunked"]["max_decode_stall_steps"] == 0,
        "chunked lost nothing": chk["chunked"]["lost"] == chk["unchunked"]["lost"] == 0,
        "stall chunked < unchunked": (chk["chunked"]["max_prefill_stall_tokens"]
                                      < chk["unchunked"]["max_prefill_stall_tokens"]),
        "stall bound one chunk": (chk["chunked"]["max_prefill_stall_tokens"]
                                  <= serve_bench.PREFILL_CHUNK),
        "step-TTFT p99 <= 1.10x": chk["ttft_steps_ratio"] <= CHUNKED_TTFT_STEPS_RATIO_MAX,
        "kernel touches < gather": (0 < chk["chunked"]["kv_touched_bytes"]
                                    < chk["chunked"]["kv_gathered_bytes"]),
        "chaos lost nothing": chaos["chaos_lost"] == chaos["baseline_lost"] == 0,
        "chaos all terminal": chaos["chaos_terminal"] == chaos["n_requests"],
        "chaos faults fired": (chaos["faults_alloc_fired"] > 0
                               and chaos["faults_backend_fired"] > 0),
        "chaos pool conserved": chaos["pool_conserved"],
        "chaos goodput >= 0.25 x fault-free": chaos["goodput_ratio"] >= CHAOS_GOODPUT_RATIO_MIN,
    }
    print(f"benches serve_bench full-width {PLAN_ARCH}: lockstep {srv['lockstep_rps']:.3f} "
          f"req/s, continuous {srv['continuous_rps']:.3f} req/s ({srv['speedup']:.2f}x), "
          f"goodput {srv['goodput_lockstep']:.3f} / {srv['goodput_continuous']:.3f} req/s, "
          f"TTFT p50/p99 {srv['ttft_p50_ms']:.1f}/{srv['ttft_p99_ms']:.1f} ms, TPOT "
          f"p50/p99 {srv['tpot_p50_ms']:.2f}/{srv['tpot_p99_ms']:.2f} ms, "
          f"{srv['tokens_out']} tokens over {srv['decode_steps']} decode steps "
          f"(block {srv['block_size']}, {srv['usable_blocks']} usable pool blocks); "
          f"chunked block {chk['chunked']['block_size']}, step-TTFT ratio "
          f"{chk['ttft_steps_ratio']:.3f}, stall tokens "
          f"{chk['chunked']['max_prefill_stall_tokens']} vs "
          f"{chk['unchunked']['max_prefill_stall_tokens']} (chunk "
          f"{serve_bench.PREFILL_CHUNK}); chaos "
          f"{chaos['chaos_finished']} finished {chaos['chaos_refused']} refused "
          f"{chaos['chaos_expired']} expired, goodput ratio {chaos['goodput_ratio']:.2f}")
    failed = [k for k, ok in gates.items() if not ok]
    print(f"benches serve_bench gates (benchmarks/check_thresholds.py:194-301): "
          f"{len(gates) - len(failed)}/{len(gates)} held" + (f"; failed {failed}" if failed else ""))
    if failed:
        raise AssertionError(f"serve_bench gates failed: {failed}")

    q, kp, vp, bt, cl = last["args"]
    got = paged_decode_cuda(q, kp, vp, bt, cl, **last["kw"])
    want = paged_decode_ref(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and got.shape == q.shape):
        raise AssertionError("paged_decode output on the served pool not finite")
    err = float((got.float() - want.float()).abs().max())
    print(f"benches serve_bench paged_decode on the served pool (last layer, last step, "
          f"cache_len={cl.tolist()}): max_abs_err={err:.3e} (tol {TOL['bfloat16']})")
    if not err <= TOL["bfloat16"]:
        raise AssertionError(f"paged_decode disagrees on the served pool: {err}")
    del params, last, q, kp, vp, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": sum(launches.values()), "max_abs_err": err, "seconds": secs,
            "results": results}


def benches_kernel_engine() -> dict:
    """(e) ``kernel_bench.run()`` (model rows, ``ref_us`` rows and the four
    ``card_us`` rows) and ``engine_bench`` (``run``,
    ``ledger_breakdown_parity``, ``calibration_accuracy`` and
    ``campaign_accuracy`` on a fresh ledger), with the reference's gates."""
    import torch

    from repro_torch.bench import engine_bench, kernel_bench

    def out(line):
        print(f"benches {line}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kern = kernel_bench.run(out)
    secs = {"kernel_bench": time.perf_counter() - t0}
    for name in ("conv_mm", "flash_attention", "ssm_scan", "moe_dispatch", "paged_decode"):
        if not kern[name]["tuned_us"] <= kern[name]["default_us"] * (1 + 1e-9):
            raise AssertionError(f"kernel_bench {name}: tuned model over default")
    if not (kern["paged_decode"]["vs_gather"] >= 1.0 and kern["serve_kv_joint"]["aligned"]
            and (kern["second_call_hits"], kern["second_call_misses"]) == (6, 0)):
        raise AssertionError(f"kernel_bench model rows: {kern}")
    for name, row in kern["card"].items():     # within tolerance, or run() raised
        if row["launches"] != 35 * row["configs"]:
            raise AssertionError(f"kernel_bench card row {name}: {row['launches']} "
                                 f"launches for {row['configs']} configs x 35")

    t0 = time.perf_counter()
    eng = engine_bench.run(out, device="cuda")
    secs["engine_bench"] = time.perf_counter() - t0
    print(f"benches engine_bench: batched/scalar max_dev {eng['max_dev']:.3e} (tol "
          f"{ENGINE_PARITY_TOL}), ledger parity {eng['ledger_parity_dev']:.3e} (tol "
          f"{LEDGER_PARITY_RTOL}); calibration MAPEs are against the repo's "
          f"host-measured fixture benchmarks/cache/cnn_profile.json, not this card")
    if not (eng["max_dev"] <= ENGINE_PARITY_TOL
            and eng["ledger_parity_dev"] <= LEDGER_PARITY_RTOL
            and eng["ledger_energy_parity_dev"] <= LEDGER_PARITY_RTOL
            and eng["phi_mape_cal"] <= eng["phi_mape_uncal"]):
        raise AssertionError(f"engine_bench gates: {eng}")
    ledger = ROOT / "build" / "repro_torch" / "benches_campaign_smoke.jsonl"
    ledger.unlink(missing_ok=True)
    counts = kernel_counts()
    window = TunerWindow()
    t0 = time.perf_counter()
    camp = engine_bench.campaign_accuracy(out, ledger_path=str(ledger), device="cuda")
    secs["campaign_accuracy"] = time.perf_counter() - t0
    window.report("benches campaign_accuracy")
    print(f"benches campaign_accuracy: {camp['measured']} reduced smoke cells measured "
          f"on the card in {secs['campaign_accuracy']:.1f} s; forest held-out Φ / Γ MAPE "
          f"{camp.get('forest_phi_mape', float('nan')):.4f} / "
          f"{camp.get('forest_gamma_mape', float('nan')):.4f}")
    if camp["measured"] != 16 or "forest_phi_mape" not in camp \
            or camp.get("breakdown_parity_dev", 1.0) > LEDGER_PARITY_RTOL:
        raise AssertionError(f"campaign_accuracy: {camp}")
    if {n: c[0] for n, c in kernel_counts().items()} != {n: c[0] for n, c in counts.items()}:
        raise AssertionError("the smoke campaign's measured steps launched a kernel")
    return {"kernel": kern, "engine": eng, "campaign": camp, "seconds": secs}


def benches_phase(trained: dict) -> dict:
    """The planner, the launcher's ``--auto-mesh`` and the three benches
    (see the module docstring, phase 11)."""
    from repro_torch.configs.registry import get_config

    t0 = time.perf_counter()
    drawing = host_draw(get_config(PLAN_ARCH))
    secs = {}
    for name, fn in (("planner", lambda: benches_planner(trained)),
                     ("planner_bench", benches_planner_bench),
                     ("launcher", lambda: benches_launcher(trained)),
                     ("serve_bench", lambda: benches_serve(drawing)),
                     ("kernel_engine_bench", benches_kernel_engine)):
        t1 = time.perf_counter()
        secs[name] = (fn(), time.perf_counter() - t1)
        print(f"benches {name} done in {secs[name][1]:.1f} s")
    print(f"benches phase done in {time.perf_counter() - t0:.1f} s")
    return {**{name: r for name, (r, _) in secs.items()}, "drawing": drawing}


# ---------------------------------------------------------------------------
# Sharded execution: the dry-run, one real rank, rank 0 of a sharded layout
# (repro_torch.launch.{mesh,lowering,dryrun}, repro_torch.distributed)
# ---------------------------------------------------------------------------

# (a) the dry-run's cells: (mesh, arch, shape); the production 16x16 mesh,
# one 2x16x16 cell, the same arch and shape on 1x1 (no collective), and
# the planner's 1x2x4 layout of the train cell (a 2x4 mesh) for (c)
DIST_SHAPE = "train_b4_s2048"
DRYRUN_CELLS = (("16x16", "internlm2-1.8b", "train_4k"),
                ("16x16", "qwen3-4b", "train_4k"),
                ("16x16", "qwen3-4b", "prefill_32k"),
                ("16x16", "qwen3-4b", "decode_32k"),
                ("16x16", "qwen3-moe-30b-a3b", "train_4k"),
                ("2x16x16", "internlm2-1.8b", "train_4k"),
                ("1x1", "internlm2-1.8b", "train_4k"),
                ("2x4", "internlm2-1.8b", DIST_SHAPE))
DRYRUN_DIR = ROOT / "build" / "repro_torch" / "dist"
# the child's own limit, from its start (it takes about 90 s); collected
# later than that, it is waited for only what is left of it
DRYRUN_TIMEOUT_S = 900
# (c) the planner's chosen layout of the train cell over 8 devices (pipe x
# data x model); its per-device Γ and Φ are read from the benches phase's plan
DIST_LAYOUT, DIST_DESCRIPTOR = (2, 4), "1x2x4"
DIST_STEPS = 2


def dryrun_child(out_dir: str) -> None:
    """The dry-run's cells (``DRYRUN_CELLS``), each through
    ``repro_torch.launch.dryrun.main`` on the card's spec into one ledger,
    then every cell again (each must print ``DONE``) and the roofline
    table; run in a child process beside the rest of the phase (the
    traces are host work on meta tensors).  Its last line is ``DRYRUN_RESULT``
    with the ledger's records and the card's kernel launches and memory
    before and after."""
    import contextlib
    import io

    import torch

    from repro_torch.bench import roofline_table
    from repro_torch.configs.base import SHAPES, ShapeSpec
    from repro_torch.launch import dryrun

    t_start = time.perf_counter()
    torch.set_num_threads(1)
    torch.cuda.init()
    SHAPES[DIST_SHAPE] = ShapeSpec(DIST_SHAPE, PLAN_SEQ, PLAN_BATCH, "train")
    ledger = str(Path(out_dir) / "dryrun.jsonl")
    before = (kernel_counts(), torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())
    secs, passes = {}, []
    for rep in range(2):
        buf = io.StringIO()
        for mesh, arch, shape in DRYRUN_CELLS:
            t0 = time.perf_counter()
            argv = ["--arch", arch, "--shape", shape, "--out", ledger, "--device", "cuda"]
            argv += ["--multi-pod", "on"] if mesh == "2x16x16" else ["--mesh", mesh]
            with contextlib.redirect_stdout(buf):
                dryrun.main(argv)
            secs.setdefault(f"{arch}|{shape}|{mesh}", []).append(time.perf_counter() - t0)
        print(buf.getvalue(), flush=True)
        passes.append(buf.getvalue())
    roofline_table.run(path=ledger)
    torch.cuda.synchronize()
    after = (kernel_counts(), torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())
    with open(ledger) as f:
        records = [json.loads(line) for line in f if line.strip()]
    print("DRYRUN_RESULT " + json.dumps({
        "records": records, "seconds": secs, "child_s": time.perf_counter() - t_start,
        "done_second": passes[1].count("DONE "), "traced_second": passes[1].count("=== "),
        "kernels_before": before[0], "kernels_after": after[0],
        "allocated": [before[1], after[1]], "max_allocated": [before[2], after[2]]}),
        flush=True)


def dryrun_start():
    """Start :func:`dryrun_child` in a child process (its output into
    ``build/repro_torch/dist/dryrun.log``, the directory made afresh);
    returns (process, log path, start time)."""
    import shutil

    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    log = DRYRUN_DIR / "dryrun.log"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), REPRO_TORCH_TUNING_CACHE=str(DRYRUN_DIR / "tuning.json"))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.dryrun_child({str(DRYRUN_DIR)!r})"],
            cwd=str(ROOT), env=env, stdout=f, stderr=subprocess.STDOUT)
    print(f"dist dry-run started in a child process (pid {proc.pid}): "
          f"{len(DRYRUN_CELLS)} cells, log {log.relative_to(ROOT)}", flush=True)
    return proc, log, time.perf_counter()


def dist_dryrun(started) -> dict:
    """(a) The dry-run's result: every cell traced, every cell ``DONE`` on
    the second call, collective bytes > 0 on each multi-device cell and 0
    on the 1x1 cell, all-to-all bytes > 0 on the MoE cell, each record's
    class breakdown re-summing to its aggregates (rel
    ``LEDGER_PARITY_RTOL``), no kernel launched and nothing allocated on
    the card."""
    proc, log, t0 = started
    try:
        proc.wait(timeout=max(DRYRUN_TIMEOUT_S - (time.perf_counter() - t0), 1))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    text = log.read_text()
    for line in text.splitlines():
        if not line.startswith("DRYRUN_RESULT "):
            print(f"dist dryrun | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"the dry-run child exited {proc.returncode}")
    res = json.loads(text.split("DRYRUN_RESULT ", 1)[1].splitlines()[0])
    recs = {(r["arch"], r["shape"], r["mesh"]): r for r in res["records"]}
    failed = [k for k, r in recs.items() if r.get("failed") or r.get("skipped")]
    if len(recs) != len(DRYRUN_CELLS) or failed:
        raise AssertionError(f"dry-run cells not all traced: {len(recs)} records, {failed}")
    if res["done_second"] != len(DRYRUN_CELLS) or res["traced_second"] != 0:
        raise AssertionError(f"the second dry-run call retraced: {res['done_second']} DONE, "
                             f"{res['traced_second']} traced")
    if res["kernels_before"] != res["kernels_after"] or \
            res["max_allocated"][0] != res["max_allocated"][1] or \
            res["allocated"][0] != res["allocated"][1]:
        raise AssertionError(f"the dry-run launched a kernel or allocated on the card: {res}")
    for (arch, shape, mesh), r in sorted(recs.items()):
        cls = r["class_breakdown"]
        for key in ("flops", "hbm_bytes", "collective_bytes"):
            total = sum(c[key] for c in cls.values())
            if abs(total - r[key]) > LEDGER_PARITY_RTOL * max(abs(r[key]), 1.0):
                raise AssertionError(f"{arch} {shape} {mesh}: class {key} {total} != {r[key]}")
        multi = r["n_devices"] > 1
        if multi != (r["collective_bytes"] > 0):
            raise AssertionError(f"{arch} {shape} {mesh}: collective bytes "
                                 f"{r['collective_bytes']} on {r['n_devices']} device(s)")
        secs = res["seconds"][f"{arch}|{shape}|{mesh}"]
        print(f"dist dryrun {arch} × {shape} [{mesh}]: {r['n_devices']} devices, per device "
              f"FLOPs {r['flops']:.4e}, HBM bytes {r['hbm_bytes']:.4e}, collective bytes "
              f"{r['collective_bytes']:.4e} {json.dumps(r['bytes_by_kind'])}; compute "
              f"{r['compute_s'] * 1e3:.2f} ms, memory {r['memory_s'] * 1e3:.2f} ms, collective "
              f"{r['collective_s'] * 1e3:.2f} ms, dominant {r['dominant']}; per-device HBM "
              f"{r['per_device_hbm_gb']:.3f} GB ({'fits' if r['fits_hbm'] else 'OVER'}); "
              f"useful {r['useful_ratio']:.3f}; sequence-parallel hint {r['sp']}; traced "
              f"in {secs[0]:.1f} s, second call "
              f"{secs[1]:.2f} s")
    moe = recs[("qwen3-moe-30b-a3b", "train_4k", "16x16")]
    if not moe["bytes_by_kind"].get("all-to-all", 0) > 0:
        raise AssertionError(f"no all-to-all bytes on the MoE cell: {moe['bytes_by_kind']}")
    print(f"dist dryrun: {len(recs)} cells traced and re-read in {res['child_s']:.1f} s of "
          f"the child (beside the train phase; collected {wall:.1f} s after its start, "
          f"limit {DRYRUN_TIMEOUT_S} s from its start); kernel launches and card memory "
          f"unchanged "
          f"({res['max_allocated'][0]} bytes peak)")
    return {"records": recs, "wall": wall}


def dist_real_rank(drawing, trained: dict) -> dict:
    """(b) One real rank: an ``nccl`` group of world size 1, full-width
    internlm2-1.8b (the seed-0 parameters the benches phase drew) trained
    one step at B 4 x S 2048 through ``Trainer(mesh=make_mesh((1, 1)),
    state_shardings=train_state_shardings(...))``; its first loss against
    the train phase's.  Then the launcher's ``--auto-mesh 1`` (reduced) in
    the same group: one device, trained unsharded."""
    import contextlib
    import gc
    import io

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.optimizer import init_opt_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    store = DRYRUN_DIR / "nccl_store"
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    print(f"dist real rank: process group up ({dist.get_backend()}, world "
          f"{dist.get_world_size()})", flush=True)
    try:
        cfg = get_config(PLAN_ARCH)
        shape = ShapeSpec("train", PLAN_SEQ, PLAN_BATCH, "train")
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        trainer = Trainer(cfg, shape, tcfg=TrainerConfig(seed=0), mesh=mesh,
                          state_shardings=sh.train_state_shardings(cfg, mesh))
        model = drawing.result()[0].to("cuda")        # the seed-0 draw, unmodified

        def init():
            return trainer.place({"params": model, "opt": init_opt_state(
                dict(model.named_parameters()), trainer.opt_cfg)})

        trainer.init_state = init
        t0 = time.perf_counter()
        out = trainer.train(1)
        secs = time.perf_counter() - t0
        loss = out["history"][0]["loss"]
        if not isinstance(out["state"]["params"].embed, DTensor):
            raise AssertionError("the trainer's state is not on the mesh")
        gap = abs(loss - trained["first_loss"]) / abs(trained["first_loss"])
        print(f"dist real rank: nccl world size {dist.get_world_size()}, mesh (1, 1) "
              f"{tuple(mesh.mesh_dim_names)}, {PLAN_ARCH} B={PLAN_BATCH} S={PLAN_SEQ} one "
              f"step in {secs:.1f} s ({out['history'][0]['dt'] * 1e3:.1f} ms): first loss "
              f"{loss:.6f} against the train phase's {trained['first_loss']:.6f}: relative "
              f"difference {gap:.3e} (tol {LAUNCH_LOSS_RTOL})")
        if not gap <= LAUNCH_LOSS_RTOL:
            raise AssertionError(f"the sharded trainer's first loss disagrees: {gap}")
        del out, trainer, model
        gc.collect()
        torch.cuda.empty_cache()
        argv = ["--arch", PLAN_ARCH, "--reduced", "--steps", "1", "--batch", "4", "--seq",
                "32", "--device", "h100", "--auto-mesh", "1"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            summary = launch.main(argv)
        line = next((ln for ln in buf.getvalue().splitlines() if ln.startswith("auto-mesh:")),
                    "")
        print(f"dist real rank launcher {' '.join(argv)}: {line!r}, first loss "
              f"{summary['first_loss']:.6f}")
        if "is one device — training unsharded" not in line or summary["steps"] != 1 \
                or not np.isfinite(summary["first_loss"]):
            raise AssertionError(f"the launcher's --auto-mesh 1: {line!r} {summary}")
    finally:
        dist.destroy_process_group()
    return {"gap": gap, "seconds": secs}


def dist_rank0(plan) -> dict:
    """(c) Rank 0 of the planner's 1x2x4 layout (2-way data x 4-way model)
    of full-width internlm2-1.8b, train B 4 x S 2048, run for real on the
    card under a ``fake`` group of 8 (its collectives move nothing, so its
    values are not results): the state placed by
    ``train_state_shardings`` (zero-filled parameters, no draw), the
    trainer's steps; the measured per-device Γ (``max_memory_allocated``
    over the steps, the state included) and step time beside the
    prediction of ``plan`` (the benches phase's plan over 8 devices) and
    the dry-run's ``per_device_hbm_gb`` of the same cell.  Each local
    shard must own its storage, no more."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizer import init_opt_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    planned = plan.decision_for(DIST_DESCRIPTOR)
    if planned is None:
        raise AssertionError(f"the plan over 8 devices has no {DIST_DESCRIPTOR}")
    planned_gb, planned_ms = planned.gamma_mb / 1e3, planned.phi_ms
    cfg = get_config(PLAN_ARCH)
    shape = ShapeSpec("train", PLAN_SEQ, PLAN_BATCH, "train")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    mem = {}
    with fake_world(8):
        mesh = make_mesh(DIST_LAYOUT, ("data", "model"), device="cuda")
        trainer = Trainer(cfg, shape, tcfg=TrainerConfig(seed=0), mesh=mesh)

        def init():
            model = T.LM(cfg, device="cuda")
            state = trainer.place({"params": model, "opt": init_opt_state(
                dict(model.named_parameters()), trainer.opt_cfg)})
            torch.cuda.synchronize()
            mem["state"] = torch.cuda.memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            return state

        trainer.init_state = init
        t0 = time.perf_counter()
        out = trainer.train(DIST_STEPS)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        embed = out["state"]["params"].embed
        local = embed.to_local()
        print(f"dist rank 0: backend {dist.get_backend()} world {dist.get_world_size()}, "
              f"mesh {DIST_LAYOUT} on {mesh.device_type}; embed {tuple(embed.shape)} "
              f"{embed.placements} -> local {tuple(local.shape)} on {local.device}")
        if local.device.type != "cuda":
            raise AssertionError(f"the fake group placed the shard on {local.device}")
        over = [n for n, p in out["state"]["params"].named_parameters()
                if p.to_local().untyped_storage().nbytes()
                != p.to_local().numel() * p.to_local().element_size()]
        if over:
            raise AssertionError(f"local shards hold more storage than their own: {over}")
    dts = [h["dt"] for h in out["history"]]
    del out, trainer, embed, local
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = dts[-1] * 1e3
    print(f"dist rank 0 of 1x2x4 ({PLAN_ARCH} B={PLAN_BATCH} S={PLAN_SEQ}, zero-filled, "
          f"collectives of a fake group): {DIST_STEPS} steps in {secs:.1f} s, step times "
          f"{', '.join(f'{d * 1e3:.1f}' for d in dts)} ms; state {mem['state'] / 1e9:.3f} GB, "
          f"Γ (max_memory_allocated over the steps, state included) {peak / 1e9:.3f} GB; "
          f"the benches phase's plan of {DIST_DESCRIPTOR} over 8 devices (chosen "
          f"{plan.chosen.layout.descriptor}): Γ {planned_gb:.3f} GB (measured / planned "
          f"{peak / 1e9 / planned_gb:.3f}), Φ {planned_ms:.2f} ms (last step / planned "
          f"{step_ms / planned_ms:.3f})")
    if not (peak > 0 and len(dts) == DIST_STEPS):
        raise AssertionError(f"rank 0's steps did not complete: {dts}, Γ {peak}")
    return {"gamma": peak, "step_ms": step_ms, "seconds": secs}


def dist_rank0_against(rank0: dict, dry: dict) -> None:
    """(c)'s measured Γ and step time beside the dry-run's per-device
    numbers of the same cell (the train cell on the 2x4 mesh)."""
    cell = dry["records"][(PLAN_ARCH, DIST_SHAPE, "2x4")]
    print(f"dist rank 0 against the dry-run's 1x2x4 cell: per_device_hbm_gb "
          f"{cell['per_device_hbm_gb']:.3f} GB (measured / dry-run "
          f"{rank0['gamma'] / 1e9 / cell['per_device_hbm_gb']:.3f}), its roofline step "
          f"{cell['step_s'] * 1e3:.2f} ms (dominant {cell['dominant']}; the last step / "
          f"roofline {rank0['step_ms'] / (cell['step_s'] * 1e3):.3f})")


def dist_thresholds(benches: dict, coll: dict) -> None:
    """(d) ``check_thresholds.evaluate`` over the results the benches phase
    holds and ``collective_calibration``'s: every condition printed as
    the reference states it; a ``FAIL`` fails the run."""
    from repro_torch.bench import check_thresholds

    if not coll:
        raise AssertionError("collective_calibration returned nothing (its CPU ranks or "
                             "its fit failed)")
    ke, serve = benches["kernel_engine_bench"], benches["serve_bench"]["results"]
    results = {"engine": ke["engine"], "campaign": ke["campaign"],
               "planner": benches["planner_bench"], "collective": coll,
               "serve": serve["run"], "chunked": serve["chunked"], "chaos": serve["chaos"],
               "kernel": ke["kernel"]}
    failures = check_thresholds.evaluate(results, lambda line: print(f"dist thresholds {line}"))
    print(f"dist thresholds: {len(failures)} of the reference's conditions failed")
    if failures:
        raise AssertionError(f"check_thresholds: {failures}")


def dist_phase(benches: dict, trained: dict, dryrun_started) -> dict:
    """(a) the dry-run, whose child process ``main`` started before the
    train phase, and (d)'s collective calibration on two CPU ranks,
    started first and run beside (b) one real rank and (c) rank 0 of a
    sharded layout; then their results and the reference's thresholds (see
    the module docstring, phase 12).  The dry-run's host work runs beside
    the train phase, whose steps are the card's time (device idle about
    2%, their time unmoved by it); beside the host-bound phases (layers,
    serving, the profiled CNN) it slowed each by 15-30%."""
    from repro_torch.bench import engine_bench

    t0 = time.perf_counter()
    ledger = DRYRUN_DIR / "collective.jsonl"
    ledger.unlink(missing_ok=True)
    lines = []
    pool = ThreadPoolExecutor(1)
    calibrating = pool.submit(engine_bench.collective_calibration, lines.append,
                              ledger_path=str(ledger))
    pool.shutdown(wait=False)
    real = dist_real_rank(benches["drawing"], trained)
    rank0 = dist_rank0(benches["planner"]["plans"][8])
    dry = dist_dryrun(dryrun_started)
    dist_rank0_against(rank0, dry)
    t1 = time.perf_counter()
    coll = calibrating.result()
    for line in lines:
        print(f"dist collective_calibration {line}")
    print(f"dist collective_calibration on two gloo CPU ranks: {coll} (waited "
          f"{time.perf_counter() - t1:.1f} s after (c))")
    dist_thresholds(benches, coll)
    print(f"dist phase done in {time.perf_counter() - t0:.1f} s")
    return {"dryrun": dry, "real": real, "rank0": rank0, "collective": coll}


def dryrun_stop(started) -> None:
    """Kill the dry-run child if it still runs (the script failed first)."""
    proc = started[0]
    if proc.poll() is None:
        proc.kill()
        proc.wait()


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
    # the tensor-core kernels: bf16 paged decode, flash (bf16 and f32) and
    # conv_mm, ssd_chunk (3xTF32); both conv_mm kernels are wgmma kernels
    # (HGMMA); every f32 flash and conv_mm instantiation is held on its own
    for name, lib in zip(wrappers, libs):
        mma = sass_mma_count(lib._name)
        if mma is None:
            print(f"build {name} SASS tensor-core instructions: not available (no cuobjdump)")
            continue
        print(f"build {name} SASS tensor-core instructions (cuobjdump -sass): "
              f"HGMMA {mma['HGMMA']}, HMMA {mma['HMMA']}")
        if not mma["HGMMA"] + mma["HMMA"] > 0:
            raise AssertionError(f"the {name} library has no tensor-core instruction")
        if name == "conv_mm" and not mma["HGMMA"] > 0:
            raise AssertionError("the conv_mm library has no HGMMA instruction")
    # each f32 flash instantiation: S on wgmma (HGMMA), P·V on mma.sync
    # (HMMA); each 3xTF32 paged decode instantiation: mma.sync (HMMA); each
    # f32 conv_mm instantiation: wgmma (HGMMA)
    check_build("flash_attention f32", libs[2]._name,
                Path(libs[2]._name).with_suffix(".log").read_text(),
                FLASH_F32_INSTANTIATIONS, ("HGMMA", "HMMA"))
    check_build("paged_decode 3xTF32", libs[0]._name,
                Path(libs[0]._name).with_suffix(".log").read_text(),
                DECODE_TF32_INSTANTIATIONS, ("HMMA",))
    check_build("conv_mm f32", libs[1]._name,
                Path(libs[1]._name).with_suffix(".log").read_text(),
                CONV_TF32_INSTANTIATIONS, ("HGMMA",))
    check_smem_formulas(libs[2], libs[3], libs[1], libs[0])

    t0 = time.perf_counter()
    tuned = tune_phase()
    print(f"tune phase done in {time.perf_counter() - t0:.1f} s")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    timing = kernel_phase(flush)
    t1 = time.perf_counter()
    conv_timing = conv_kernel_phase(flush)
    flash_timing = flash_kernel_phase(flush, tuned)
    ssd_timing = ssd_kernel_phase(flush, tuned)
    print(f"kernels phase done in {time.perf_counter() - t0:.1f} s (paged decode "
          f"{t1 - t0:.1f} s)")
    del flush
    torch.cuda.empty_cache()
    served = serve_phase()
    reference_launches = reference_phase()
    layered = layers_phase()
    # the dist phase's dry-run (host work on meta tensors, one core, about
    # as long as the train phase) in a child process beside the train
    # phase, whose timed steps are the card's (device idle about 2%)
    dryrun_started = dryrun_start()
    atexit.register(dryrun_stop, dryrun_started)
    trained = train_phase()
    est = served["admit"]["train_estimate"]
    print(f"admit internlm2-1.8b train bs=4 seq=2048: Γ {est.gamma_mb / 1e3:.3f} GB, Φ "
          f"{est.phi_ms:.2f} ms against the train phase's peak {trained['peak'] / 1e9:.3f} "
          f"GB and median step {trained['step_ms']:.1f} ms")
    ce = served["campaign"]["estimates"]
    meas = ce["measured"]
    print(f"campaign internlm2-1.8b train bs=4 seq=2048 against the train phase's peak "
          f"{trained['peak'] / 1e9:.3f} GB and median step {trained['step_ms']:.1f} ms: "
          f"traced estimate before the fit Γ {ce['before'].gamma_mb / 1e3:.3f} GB Φ "
          f"{ce['before'].phi_ms:.2f} ms, after Γ {ce['after'].gamma_mb / 1e3:.3f} GB Φ "
          f"{ce['after'].phi_ms:.2f} ms; forest Γ {ce['forest'][0] / 1e3:.3f} GB Φ "
          f"{ce['forest'][1]:.2f} ms; the campaign's cell "
          + (f"Γ {meas['gamma_mb'] / 1e3:.3f} GB Φ {meas['phi_ms']:.2f} ms"
             if meas else "quarantined"))
    cnn = cnn_phase()
    engine = engine_phase(cnn)
    bench = bench_phase(cnn)
    benches = benches_phase(trained)
    dist_phase(benches, trained, dryrun_started)
    card = benches["kernel_engine_bench"]["kernel"]["card"]

    def kernel_bench_fields(name: str) -> dict:
        return {"kernel_bench_launches": card[name]["launches"],
                "kernel_bench_ms": card[name]["us"] / 1e3}

    kernels = [{
        "name": "paged_decode",
        "route": "cuda",
        "source": str(decode_kernel.SOURCES[0].relative_to(ROOT)),
        "replaces": REPLACES,
        "launches": served["launches"],
        "max_abs_err": served["max_abs_err"],
        **timing,
        "moe_launches": layered["moe_launches"],
        "moe_max_abs_err": layered["moe_max_abs_err"],
        "admit_launches": served["admit"]["launches"],
        "admit_max_abs_err": served["admit"]["max_abs_err"],
        "campaign_launches": served["campaign"]["launches"],
        "campaign_max_abs_err": served["campaign"]["max_abs_err"],
        "serve_bench_launches": benches["serve_bench"]["launches"],
        "serve_bench_max_abs_err": benches["serve_bench"]["max_abs_err"],
        "reference_launches": reference_launches,
        "layers_launches": layered["paged_launches"],
        **kernel_bench_fields("paged_decode"),
    }, {
        "name": "conv_mm",
        "route": "cuda",
        "source": str(conv_kernel.SOURCES[0].relative_to(ROOT)),
        "replaces": CONV_REPLACES,
        "launches": cnn["launches"],
        "engine_launches": engine["launches"],
        "bench_launches": bench["launches"],
        "max_abs_err": max(cnn["max_abs_err"], bench["max_abs_err"]),
        **conv_timing,
        **kernel_bench_fields("conv_mm"),
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": str(flash_kernel.SOURCES[0].relative_to(ROOT)),
        "replaces": FLASH_REPLACES,
        "launches": tuned["launches"]["flash_attention"],
        **flash_timing,
        "train_launches": trained["train_launches"],
        "train_max_abs_err": trained["train_max_abs_err"],
        "train_ms": trained["train_ms"],
        "train_plain_ms": trained["train_plain_ms"],
        "train_bound_ms": trained["train_bound_ms"],
        "train_library_ms": trained["train_library_ms"],
        **kernel_bench_fields("flash_attention"),
    }, {
        "name": "ssd_chunk",
        "route": "cuda",
        "source": str(ssd_kernel.SOURCES[0].relative_to(ROOT)),
        "replaces": SSD_REPLACES,
        "launches": tuned["launches"]["ssm_scan"],
        **ssd_timing,
        "serve_launches": layered["serve_launches"],
        **kernel_bench_fields("ssd_chunk"),
    }]
    print(json.dumps({"kernels": kernels}))
    print(f"device {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
