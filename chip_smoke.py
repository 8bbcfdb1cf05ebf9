#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build — compile every CUDA kernel from the sources in this checkout,
   one ``nvcc`` per kernel, all started together (→ ``build/repro_torch/``);
3. kernels — hold each kernel against its plain PyTorch version on the
   card: paged decode at qwen3-4b decode shapes, the MM convolution on
   every convolution shape of full-width ResNet-50 and on edge cases; time
   kernel, plain version, a library yardstick and the bound with CUDA
   events;
4. serve — full-width qwen3-4b (random weights from seed 0, bf16) served
   by ``ContinuousEngine`` over the paged KV pool: 16 greedy requests,
   with the paged-decode launch count read around the run; then the
   kernel is held against its plain version on the served model's own
   inputs, and a reduced qwen3-4b on the card is held against the same
   model on the CPU (the port's plain path);
5. cnn — the paper's toolflow: one training step of a reduced ResNet-50
   on the card against the CPU; then full-width ResNet-50 (32x32,
   CIFAR-100) pruned, profiled for Γ and Φ over the paper's train levels
   and the default test levels at five batch sizes (``collect_grid``),
   with the convolution kernel's launch count read around the grid, then
   the kernel held against its plain version at every (batch size,
   convolution shape) the grid gave it; the predictor fitted on the
   train points and its Γ/Φ error printed for each test grid; and a
   traced step at batch 128 (where the time goes);
6. a ``{"kernels": [...]}`` JSON line, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Without CUDA, or without the rest of the repository beside it, it fails
before printing any result.
"""

from __future__ import annotations

import json
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
    per kernel instantiation."""
    regs, spills = [], []
    for line in log.splitlines():
        if "spill stores" in line:
            spills.append(int(line.split("bytes spill stores")[0].split(",")[-1]))
        elif "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split("registers")[0]))
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{sum(x > 0 for x in spills)} with spills (max {max(spills)} bytes)")


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


def kernel_phase(flush) -> dict:
    import torch

    from repro_torch.kernels.paged_decode.kernel import paged_decode_cuda
    from repro_torch.kernels.paged_decode.ref import paged_decode_ref

    bs, NB = DECODE["bs"], DECODE["NB"]
    edges = [0, bs - 1, bs, 2 * bs - 1, 3 * bs, 5 * bs + 17, NB * bs - 1, 700]
    for Dh in (128, 64):
        for name, dtype in (("bfloat16", torch.bfloat16),
                            ("float32", torch.float32)):
            args = decode_case(dtype, Dh, edges)
            want = paged_decode_ref(*args)
            for ns in (1, 2, 4):
                got = paged_decode_cuda(*args, n_splits=ns)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                print(f"kernel paged_decode Dh={Dh} {name} n_splits={ns}: "
                      f"max_abs_err={err:.3e} (tol {TOL[name]})")
                if not err <= TOL[name]:
                    raise AssertionError(f"paged_decode disagrees: {err}")
    for H, Hkv in ((32, 32), (32, 4), (40, 8)):      # rep 1, 8 (two passes), 5
        args = decode_case(torch.bfloat16, 128, edges, H=H, Hkv=Hkv)
        err = float((paged_decode_cuda(*args).float()
                     - paged_decode_ref(*args).float()).abs().max())
        print(f"kernel paged_decode Dh=128 bfloat16 H={H} Hkv={Hkv}: "
              f"max_abs_err={err:.3e} (tol {TOL['bfloat16']})")
        if not err <= TOL["bfloat16"]:
            raise AssertionError(f"paged_decode disagrees: {err}")

    # timing at the serving shape: bf16, tiling default, ragged fills
    # drawn like the served requests (prompt 64..1536 + 16 generated)
    fills = np.random.default_rng(1).integers(64, 1537, DECODE["B"]) + 16
    args = decode_case(torch.bfloat16, DECODE["Dh"], fills.tolist(), seed=1)
    lib_err = float((library_decode(*args).float()
                     - paged_decode_ref(*args).float()).abs().max())
    ms = time_ms(lambda: paged_decode_cuda(*args), flush)
    plain_ms = time_ms(lambda: paged_decode_ref(*args), flush)
    library_ms = time_ms(lambda: library_decode(*args), flush)
    ms_again = time_ms(lambda: paged_decode_cuda(*args), flush)
    bound_ms, bound_by = bound(args[0], args[1], args[4])
    live = int((args[4].long() + 1).sum())
    print(f"timing paged_decode B=8 H=32 Hkv=8 Dh=128 bs=256 NB=8 bf16 "
          f"live_tokens={live}: kernel {ms:.4f} / {ms_again:.4f} ms, plain "
          f"{plain_ms:.4f} ms, gather+sdpa {library_ms:.4f} ms "
          f"(max_abs_err vs plain {lib_err:.3e}), bound {bound_ms:.4f} ms "
          f"({bound_by}) -> {bound_ms / ms:.1%} of bound")
    splits = {ns: time_ms(lambda: paged_decode_cuda(*args, n_splits=ns), flush)
              for ns in (2, 4, 8)}
    print("timing paged_decode same inputs by n_splits: 1: "
          f"{ms:.4f} ms, " + ", ".join(f"{ns}: {t:.4f} ms"
                                       for ns, t in splits.items()))
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
    t0 = time.perf_counter()
    try:
        engine.run(requests)
        torch.cuda.synchronize()
    finally:
        ops.paged_decode_cuda = launch
    wall = time.perf_counter() - t0
    launches = paged_decode_cuda.launches
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + t / 1e3 / n_steps
    dev_ms = sum(by_kernel.values())
    paged = sum(t for k, t in by_kernel.items() if "paged_decode_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"decode step, 8 slots at ~256-280 tokens of context: host wall "
          f"{wall_ms:.2f} ms/step, device kernel time {dev_ms:.2f} ms/step "
          f"(device idle {1 - dev_ms / wall_ms:.1%}), paged_decode "
          f"{paged:.3f} ms/step ({paged / dev_ms:.1%} of kernel time)")
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
    t0 = time.perf_counter()
    points = {name: collect_grid(spec, cache, repeats=repeats, warmup=warmup,
                                 device="cuda")
              for name, spec in grids.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = conv_mm_cuda.launches
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
    return {"launches": launches, "max_abs_err": err}


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
    conv = sum(t for k, t in kernels.items() if "conv_mm_kernel" in k)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels.conv_mm import kernel as conv_kernel
    from repro_torch.kernels.paged_decode import kernel as decode_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    wrappers = {"paged_decode": (decode_kernel.paged_decode_cuda, decode_kernel.SOURCES),
                "conv_mm": (conv_kernel.conv_mm_cuda, conv_kernel.SOURCES)}
    with ThreadPoolExecutor(len(wrappers)) as pool:   # one nvcc each, together
        libs = list(pool.map(lambda w: w[0].load(), wrappers.values()))
    for (name, (wrapper, sources)), lib in zip(wrappers.items(), libs):
        log = Path(lib._name).with_suffix(".log").read_text()
        print(f"build {name} ({', '.join(str(s.relative_to(ROOT)) for s in sources)}): "
              f"nvcc {wrapper.build_seconds:.1f} s; ptxas: {ptxas_summary(log)}")
    print(f"build all kernels ready in {time.perf_counter() - t0:.1f} s")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    timing = kernel_phase(flush)
    conv_timing = conv_kernel_phase(flush)
    del flush
    served = serve_phase()
    reference_phase()
    cnn = cnn_phase()

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
        "max_abs_err": cnn["max_abs_err"],
        **conv_timing,
    }]
    print(json.dumps({"kernels": kernels}))
    print(f"device {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
