#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build — compile every CUDA kernel of the serving path from the sources
   in this checkout (``nvcc`` → ``build/repro_torch/``);
3. kernels — hold each kernel against its plain PyTorch version on the
   card at qwen3-4b decode shapes, and time kernel, plain version, a
   library yardstick and the HBM bound with CUDA events;
4. serve — full-width qwen3-4b (random weights from seed 0, bf16) served
   by ``ContinuousEngine`` over the paged KV pool: 16 greedy requests,
   with each kernel's launch count read around the run; then the kernel
   is held against its plain version on the served model's own inputs,
   and a reduced qwen3-4b on the card is held against the same model on
   the CPU (the port's plain path);
5. a ``{"kernels": [...]}`` JSON line, the card line again, and last
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
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# qwen3-4b decode at the serving configuration below
DECODE = dict(B=8, H=32, Hkv=8, Dh=128, bs=256, NB=8)
TOL = {"float32": 2e-5, "bfloat16": 1e-2}
REPLACES = "src/repro/kernels/paged_decode/kernel.py:120"


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels.paged_decode.kernel import SOURCES, paged_decode_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = paged_decode_cuda.load()
    log = Path(lib._name).with_suffix(".log").read_text()
    print(f"build paged_decode ({', '.join(str(s.relative_to(ROOT)) for s in SOURCES)}): "
          f"nvcc {paged_decode_cuda.build_seconds:.1f} s, ready in "
          f"{time.perf_counter() - t0:.1f} s; ptxas: {ptxas_summary(log)}")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    timing = kernel_phase(flush)
    del flush
    served = serve_phase()
    reference_phase()

    kernels = [{
        "name": "paged_decode",
        "route": "cuda",
        "source": str(SOURCES[0].relative_to(ROOT)),
        "replaces": REPLACES,
        "launches": served["launches"],
        "max_abs_err": served["max_abs_err"],
        **timing,
    }]
    print(json.dumps({"kernels": kernels}))
    print(f"device {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
