"""Open-loop serving benchmark: continuous batching against lockstep
generate (port of ``benchmarks/serve_bench.py``, whole).

Replays one synthetic Poisson arrival trace (seeded: mixed prompt
lengths, mixed token budgets) through both engines at equal ``n_slots``
and reports, per engine, sustained requests/sec plus the continuous
engine's p50/p99 TTFT and per-token latency.  The lockstep baseline is
``ServeEngine.generate`` driven the only way a lockstep server can be:
grab up to ``n_slots`` arrived requests, decode until the *longest*
finishes, return the batch — short requests hold their slots, which is
exactly the idle time continuous batching reclaims.  Then the chaos row
(the same trace under a seeded fault plan, replayed on engine steps) and
the chunked-prefill row.

Methodology, as the reference's:

* open-loop — arrivals follow the trace's wall-clock offsets whether or
  not the server keeps up, so queueing delay lands in TTFT (the chaos
  row's follow engine steps, ``run_stepped``, where the reference's
  follow the clock);
* each engine runs the trace twice on one instance and the second pass is
  measured (the first warms the tuner and the allocator);
* lockstep TTFT is batch-completion-based; the gate compares sustained
  req/s and requires the continuous engine to be never worse;
* goodput = finished requests whose end-to-end per-output-token latency
  met ``GOODPUT_TPOT_MS``, per second of wall clock.

The reference's constants and trace.  Each ``run*`` takes ``device``
(default ``"cuda"``; it raises without a card unless given ``"cpu"``) and
optional ``cfg=`` and ``params=``, so that one draw serves all three; by
default each draws the reference's ``internlm2-1.8b`` at ``reduced=True``
from seed 0.  The reference hands its ``KernelTuner`` to the engine,
which resolves the paged pool's block size through it; the port resolves
the same block size through the same tuner, fits it to the pool as its
engine fits any block it resolves (``fit_block_size``: a block for every
slot; the reference's engine leaves half its slots idle where the tuner
picks a block of ``MAX_LEN``, as a TPU or GPU spec does) and passes it
in the config.  ``run_chunked`` passes both its engines the tuner's block
as it is (see there).  Each result also carries ``decode_steps_total``, the continuous engines'
decode steps over every pass (warm-up passes included): what a caller
counting paged-decode launches around the call holds them to.

    PYTHONPATH=src python -m repro_torch.bench.serve_bench [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.bench.common import csv_line
from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.engine import CostEngine, EnsembleBackend, ForestBackend, get_device
from repro_torch.kernels.autotune import KernelTuner
from repro_torch.kernels.build import BUILD_DIR
from repro_torch.models import transformer as T
from repro_torch.serve import (
    ContinuousConfig,
    ContinuousEngine,
    FaultPlan,
    Request,
    ServeConfig,
    ServeEngine,
    fit_block_size,
    resolve_block_size,
)

__all__ = ["make_trace", "run_lockstep", "run_continuous", "run_stepped", "run",
           "run_chaos", "run_chunked"]

MAX_LEN = 64
N_SLOTS = 4
N_REQUESTS = 12
RATE_RPS = 30.0                # arrival intensity (keeps the cell loaded)
PROMPT_LENS = (5, 9, 13)       # few distinct widths → few lockstep shapes
MAX_NEW = (4, 24)              # mixed budgets: what lockstep pads away
GOODPUT_TPOT_MS = 500.0        # the reference's host-CPU smoke scale
TUNING_CACHE = str(BUILD_DIR / "serve_bench_tuning.json")


def make_trace(seed: int = 0, n: int = N_REQUESTS, rate: float = RATE_RPS):
    """[(arrival_s, prompt, max_new)] with Poisson (exponential-gap)
    arrivals — the same seed replays the same trace for both engines."""
    rng = np.random.default_rng(seed)
    t, trace = 0.0, []
    vocab_lo, vocab_hi = 2, 128
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        plen = int(rng.choice(PROMPT_LENS))
        prompt = rng.integers(vocab_lo, vocab_hi, (plen,)).astype(np.int32)
        trace.append((t, prompt, int(MAX_NEW[i % len(MAX_NEW)])))
    return trace


def _model(cfg, params, dev):
    """The caller's model, or the reference's default draw on ``dev``."""
    if cfg is None:
        cfg = get_config("internlm2-1.8b", reduced=True)
    if params is None:
        params = T.init_params(cfg, 0, device=dev)
    return cfg, params


# ---------------------------------------------------------------------------


def run_lockstep(eng: ServeEngine, trace) -> dict:
    start = time.perf_counter()
    done, i = [], 0
    while i < len(trace):
        now = time.perf_counter() - start
        if trace[i][0] > now:
            time.sleep(trace[i][0] - now)
            now = time.perf_counter() - start
        n_due = sum(1 for a, _, _ in trace[i:] if a <= now)
        batch = trace[i: i + min(max(n_due, 1), eng.scfg.n_slots)]
        i += len(batch)
        out = eng.generate([p for _, p, _ in batch],
                           max_new_tokens=max(m for _, _, m in batch))
        t_done = time.perf_counter() - start
        for j, (arrival, _, _) in enumerate(batch):
            done.append({"latency_s": t_done - arrival,
                         "tokens": int(out["token_counts"][j])})
    wall = time.perf_counter() - start
    return {"wall_s": wall, "done": done}


def run_continuous(ce: ContinuousEngine, trace, *,
                   deadline_ms: float | None = None) -> dict:
    start = time.perf_counter()
    i = 0
    while i < len(trace) or not ce.idle:
        now = time.perf_counter() - start
        while i < len(trace) and trace[i][0] <= now:
            arrival, prompt, max_new = trace[i]
            req = Request(prompt=prompt, max_new_tokens=max_new,
                          deadline_ms=deadline_ms)
            req.t_arrival = start + arrival
            ce.submit(req)
            i += 1
        if ce.idle and i < len(trace):
            time.sleep(max(0.0, trace[i][0] - now))
            continue
        ce.step()
    return {"wall_s": time.perf_counter() - start}


def run_stepped(ce: ContinuousEngine, trace, *,
                deadline_ms: float | None = None) -> dict:
    """Replay ``trace`` on the engine's steps instead of the host clock: a
    request that arrives at ``t`` s is submitted before step
    ``⌊t / CHAOS_STEP_S⌋ + 1`` of the pass, however long the steps take
    (the engine steps while idle until the next one is due).  Which step
    admits each request, and so which admissions meet a fault plan's
    planned steps, is then the same on every host.  Latencies count from
    submission."""
    start = time.perf_counter()
    first = ce._step
    due = [int(arrival // CHAOS_STEP_S) for arrival, _, _ in trace]
    i = 0
    while i < len(trace) or not ce.idle:
        while i < len(trace) and due[i] <= ce._step - first:
            _, prompt, max_new = trace[i]
            ce.submit(Request(prompt=prompt, max_new_tokens=max_new,
                              deadline_ms=deadline_ms))
            i += 1
        ce.step()
    return {"wall_s": time.perf_counter() - start}


def _goodput(latencies_per_token_ms, wall_s: float) -> float:
    met = sum(1 for t in latencies_per_token_ms if t <= GOODPUT_TPOT_MS)
    return met / wall_s if wall_s > 0 else 0.0


def run(print_fn=print, seed: int = 0, *, device="cuda", cfg=None,
        params=None) -> dict:
    dev = resolve_device(device)
    cfg, params = _model(cfg, params, dev)
    trace = make_trace(seed)

    lock = ServeEngine(cfg, params, ServeConfig(
        max_len=MAX_LEN, n_slots=N_SLOTS, eos_id=0), device=dev)
    tuner = KernelTuner(cache=TUNING_CACHE)
    block_size = fit_block_size(
        resolve_block_size(cfg, n_slots=N_SLOTS, max_len=MAX_LEN, tuner=tuner),
        n_slots=N_SLOTS, max_len=MAX_LEN)
    cont = ContinuousEngine(cfg, params, ContinuousConfig(
        max_len=MAX_LEN, n_slots=N_SLOTS, eos_id=0, block_size=block_size),
        device=dev)

    # pass 1 warms; pass 2 is measured
    run_lockstep(lock, trace)
    lk = run_lockstep(lock, trace)

    run_continuous(cont, trace)
    steps_total = cont.decode_steps
    cont.finished.clear()
    cont.refused.clear()
    cont.decode_steps = 0
    ct = run_continuous(cont, trace)
    m = cont.metrics()
    steps_total += cont.decode_steps
    if not (m["finished"] == len(trace) and m["refused"] == 0):
        raise AssertionError(f"continuous engine finished {m['finished']} of "
                             f"{len(trace)}, refused {m['refused']}")

    lock_rps = len(lk["done"]) / lk["wall_s"]
    cont_rps = m["finished"] / ct["wall_s"]
    speedup = cont_rps / lock_rps

    lock_tpot = [1e3 * d["latency_s"] / max(d["tokens"], 1)
                 for d in lk["done"]]
    cont_tpot = [1e3 * (r.t_finished - r.t_arrival) / max(r.n_generated, 1)
                 for r in cont.finished]

    out = {
        "lockstep_rps": lock_rps,
        "continuous_rps": cont_rps,
        "speedup": speedup,
        "ttft_p50_ms": m["ttft_p50_ms"],
        "ttft_p99_ms": m["ttft_p99_ms"],
        "tpot_p50_ms": m["tpot_p50_ms"],
        "tpot_p99_ms": m["tpot_p99_ms"],
        "goodput_lockstep": _goodput(lock_tpot, lk["wall_s"]),
        "goodput_continuous": _goodput(cont_tpot, ct["wall_s"]),
        "kv_bytes": m["kv_bytes"],
        "kv_dense_bytes": m["kv_dense_bytes"],
        "block_size": m["block_size"],
        "usable_blocks": cont.kv.usable_blocks,
        "n_requests": len(trace),
        "decode_steps": m["decode_steps"],
        "decode_steps_total": steps_total,
        "tokens_out": m["tokens_out"],
    }
    print_fn(csv_line("serve/lockstep_rps", lock_rps,
                      f"n={len(trace)} slots={N_SLOTS}"))
    print_fn(csv_line("serve/continuous_rps", cont_rps,
                      f"speedup={speedup:.2f}x"))
    print_fn(csv_line("serve/ttft_p50_ms", out["ttft_p50_ms"], "continuous"))
    print_fn(csv_line("serve/ttft_p99_ms", out["ttft_p99_ms"], "continuous"))
    print_fn(csv_line("serve/tpot_p50_ms", out["tpot_p50_ms"], "continuous"))
    print_fn(csv_line("serve/tpot_p99_ms", out["tpot_p99_ms"], "continuous"))
    print_fn(csv_line("serve/goodput_lockstep_rps", out["goodput_lockstep"],
                      f"tpot<= {GOODPUT_TPOT_MS}ms"))
    print_fn(csv_line("serve/goodput_continuous_rps",
                      out["goodput_continuous"],
                      f"tpot<= {GOODPUT_TPOT_MS}ms"))
    print_fn(csv_line("serve/kv_pool_mb", out["kv_bytes"] / 1e6,
                      f"dense={out['kv_dense_bytes'] / 1e6:.3g}MB "
                      f"block={out['block_size']}"))
    return out


# ---------------------------------------------------------------------------
# chaos row: the same trace under a seeded fault plan
# ---------------------------------------------------------------------------

CHAOS_POOL_TOKENS = 96         # 6 usable blocks: real pool pressure
CHAOS_FAULT_STEPS = 80         # fault window (engine drains past it)
CHAOS_P_ALLOC = 0.25
CHAOS_P_BACKEND = 0.25
CHAOS_DEADLINE_MS = 60_000.0   # wired per request; never binds at bench scale
# the chaos replay's nominal engine step: the trace's 30 req/s then arrive
# 0.75 a step, faster than 4 slots serve them (the cell stays loaded),
# within the fault window
CHAOS_STEP_S = 0.025


class _StaticForest:
    """Fitted-forest stand-in: keeps chaos admission trace-free so the row
    measures fault handling, not the cost model."""

    fitted = True
    meta: dict = {}

    def __init__(self, tag):
        self.tag = tag
        self.default_device = get_device("host_cpu")

    def content_hash(self):
        return f"serve-bench-{self.tag}"

    def predict_queries(self, queries):
        n = len(queries)
        return (np.full(n, 50.0), np.full(n, 1.0))


def _chaos_engine(cfg, params, faults, dev):
    # Two model-backed failover levels (primary → fallback forest) ahead
    # of the static floor, so injected backend crashes walk the whole
    # health chain.  (The reference also hands the engine its tuner, which
    # only resolves the block size; this config pins it.)
    gate = CostEngine(EnsembleBackend([
        ForestBackend(lm=_StaticForest("primary")),
        ForestBackend(lm=_StaticForest("fallback")),
    ]))
    return ContinuousEngine(cfg, params, ContinuousConfig(
        max_len=MAX_LEN, n_slots=N_SLOTS, eos_id=0, block_size=16,
        pool_tokens=CHAOS_POOL_TOKENS, gamma_budget_mb=1e6),
        cost_engine=gate, faults=faults, device=dev)


def _chaos_plan(seed):
    return FaultPlan.seeded(seed + 1, n_steps=CHAOS_FAULT_STEPS,
                            p_alloc=CHAOS_P_ALLOC, p_backend=CHAOS_P_BACKEND)


def _reset(ce: ContinuousEngine) -> None:
    """Clear per-pass accounting (tuner and health state stay warm) so the
    measured pass starts from a drained engine."""
    ce.finished.clear()
    ce.refused.clear()
    ce.expired.clear()
    ce.submitted = 0
    ce.decode_steps = 0
    ce._step = 0                # fault plans key on absolute step index
    ce._skew_s = 0.0
    ce._stall_run = 0
    ce.max_decode_stall_steps = 0
    ce.max_prefill_stall_tokens = 0
    ce.kv_gathered_bytes = 0.0
    ce.kv_touched_bytes = 0.0
    for k in ce.counters:
        ce.counters[k] = 0


def _arm(ce: ContinuousEngine, plan) -> None:
    """Point every injection site at a fresh plan for the measured pass."""
    ce.faults = plan
    ce.kv.faults = plan
    if ce.failover is not None:
        ce.failover.faults = plan


def run_chaos(print_fn=print, seed: int = 0, *, device="cuda", cfg=None,
              params=None) -> dict:
    """Serve the Poisson trace under a seeded fault plan and report the
    robustness row: zero lost requests, all terminal, goodput retention
    against the identical fault-free cell.  Both cells replay the trace on
    engine steps (``run_stepped``), not on the host clock as ``run`` does:
    a backend fault fires only where an admission is priced on one of the
    plan's steps, and a clock replay under host load moves the admissions
    off them (the reference replays on the clock)."""
    dev = resolve_device(device)
    cfg, params = _model(cfg, params, dev)
    trace = make_trace(seed)
    steps = {"total": 0}

    def measure(ce, plan):
        run_stepped(ce, trace, deadline_ms=CHAOS_DEADLINE_MS)  # warm
        steps["total"] += ce.decode_steps
        _reset(ce)
        _arm(ce, plan)
        wall = run_stepped(ce, trace,
                           deadline_ms=CHAOS_DEADLINE_MS)["wall_s"]
        steps["total"] += ce.decode_steps
        tpots = [1e3 * (r.t_finished - r.t_arrival) / max(r.n_generated, 1)
                 for r in ce.finished]
        return ce.metrics(), _goodput(tpots, wall)

    base_m, base_goodput = measure(
        _chaos_engine(cfg, params, faults=None, dev=dev), None)
    plan = _chaos_plan(seed)
    chaos_ce = _chaos_engine(cfg, params, faults=_chaos_plan(seed), dev=dev)
    chaos_m, chaos_goodput = measure(chaos_ce, plan)

    terminal = (chaos_m["finished"] + chaos_m["refused"]
                + chaos_m["expired"])
    ratio = (chaos_goodput / base_goodput if base_goodput > 0
             else float("inf"))
    out = {
        "n_requests": len(trace),
        "chaos_finished": chaos_m["finished"],
        "chaos_refused": chaos_m["refused"],
        "chaos_expired": chaos_m["expired"],
        "chaos_terminal": terminal,
        "chaos_lost": chaos_m["lost"],
        "faults_alloc_fired": chaos_m["faults"]["fired"]["alloc"],
        "faults_backend_fired": chaos_m["faults"]["fired"]["backend"],
        "preemptions": chaos_m["preemptions"],
        "resumes": chaos_m["resumes"],
        "failovers": chaos_m["health"]["failovers"],
        "degraded_steps": chaos_m["degraded_steps"],
        "goodput_faultfree": base_goodput,
        "goodput_chaos": chaos_goodput,
        "goodput_ratio": ratio,
        "pool_conserved": (chaos_ce.kv.n_free_blocks
                           == chaos_ce.kv.usable_blocks),
        "baseline_lost": base_m["lost"],
        "decode_steps_total": steps["total"],
    }
    print_fn(csv_line("serve/chaos_lost", out["chaos_lost"],
                      f"terminal={terminal}/{len(trace)}"))
    print_fn(csv_line(
        "serve/chaos_faults_fired",
        out["faults_alloc_fired"] + out["faults_backend_fired"],
        f"alloc={out['faults_alloc_fired']} "
        f"backend={out['faults_backend_fired']}"))
    print_fn(csv_line(
        "serve/chaos_preemptions", out["preemptions"],
        f"resumes={out['resumes']} failovers={out['failovers']} "
        f"degraded_steps={out['degraded_steps']}"))
    print_fn(csv_line("serve/chaos_goodput_rps", chaos_goodput,
                      f"faultfree={base_goodput:.2f} ratio={ratio:.2f}"))
    return out


# ---------------------------------------------------------------------------
# chunked-prefill row: long prompts interleaved with running decodes
# ---------------------------------------------------------------------------

CHUNK_MAX_LEN = 128
CHUNK_SLOTS = 4
CHUNK_SHORT = (5, 7, 9)        # decode-heavy requests already running…
CHUNK_LONG = (48, 80, 96)      # …when these long prompts arrive
CHUNK_SHORT_NEW = 110          # shorts pin their slots past the last long
CHUNK_LONG_NEW = 32            # decode budget >> chunk count (serving regime)
PREFILL_CHUNK = 32
CHUNK_REPEATS = 3              # interleaved measured repeats per mode


def _chunked_prompts(seed: int = 1):
    rng = np.random.default_rng(seed)

    def mk(n):
        return rng.integers(2, 128, (n,)).astype(np.int32)

    return [mk(n) for n in CHUNK_SHORT], [mk(n) for n in CHUNK_LONG]


def _run_chunked_pass(ce: ContinuousEngine, shorts, longs):
    """Shorts admit first and start decoding; longs arrive three steps
    later, mid-stream — exactly the stall an unchunked prefill causes."""
    t0 = time.perf_counter()
    for p in shorts:
        ce.submit(Request(prompt=p, max_new_tokens=CHUNK_SHORT_NEW))
    for _ in range(3):
        ce.step()
    for p in longs:
        ce.submit(Request(prompt=p, max_new_tokens=CHUNK_LONG_NEW))
    while not ce.idle:
        ce.step()
    return time.perf_counter() - t0


def run_chunked(print_fn=print, *, device="cuda", cfg=None, params=None) -> dict:
    """One trace through two identically configured engines — chunked
    prefill on and off.  Running-slot (short-request) p99 TPOT is the
    headline: unchunked, each long prompt's whole prefill lands between
    two of their tokens; chunked, the gap is bounded by one chunk.

    Both engines are warmed first, then the measured passes alternate
    between modes (``CHUNK_REPEATS`` each) and latency samples pool
    across repeats.  The *gated* quantities are deterministic step-count
    metrics (step-indexed TTFT, ``max_prefill_stall_tokens``); wall-clock
    ratios are reported for reference."""
    dev = resolve_device(device)
    cfg, params = _model(cfg, params, dev)
    shorts, longs = _chunked_prompts()

    # The tuner's block, not fitted to the pool, as the reference's engine
    # takes it: the row compares streams, not throughput.  Fitted, the
    # block would run all 4 slots in a pool of half their footprint, which
    # then preempts (a resumed request re-prefills, whole in one engine
    # and chunk by chunk in the other), and the decode kernel's split of a
    # table of several blocks would follow the batch; in bf16 at full width
    # either rounds the engines apart, and greedy streams part at a
    # near-tie.
    block_size = resolve_block_size(cfg, n_slots=CHUNK_SLOTS, max_len=CHUNK_MAX_LEN)
    engines, out = {}, {}
    steps_total = 0
    for tag, chunk in (("unchunked", None), ("chunked", PREFILL_CHUNK)):
        ce = ContinuousEngine(cfg, params, ContinuousConfig(
            max_len=CHUNK_MAX_LEN, n_slots=CHUNK_SLOTS, eos_id=0,
            block_size=block_size, prefill_chunk=chunk, seed=0), device=dev)
        _run_chunked_pass(ce, shorts, longs)     # warm
        engines[tag] = ce
        out[tag] = {"streams": sorted(tuple(r.tokens) for r in ce.finished),
                    "wall_s": 0.0, "ttft_ms": [], "short_tpot_ms": []}

    for _ in range(CHUNK_REPEATS):
        for tag, ce in engines.items():
            steps_total += ce.decode_steps
            _reset(ce)
            out[tag]["wall_s"] += _run_chunked_pass(ce, shorts, longs)
            m = ce.metrics()
            if not (m["finished"] == len(shorts) + len(longs) and m["lost"] == 0):
                raise AssertionError(f"chunked pass ({tag}) finished "
                                     f"{m['finished']}, lost {m['lost']}")
            out[tag]["ttft_ms"] += [1e3 * r.ttft_s for r in ce.finished
                                    if r.ttft_s is not None]
            # shorts were submitted first: identify by prompt length
            out[tag]["short_tpot_ms"] += [
                1e3 * r.tpot_s for r in ce.finished
                if r.prompt_len in CHUNK_SHORT and r.tpot_s is not None]

    for tag, ce in engines.items():
        steps_total += ce.decode_steps
        m = ce.metrics()                         # last repeat's counters
        # step-indexed TTFT: deterministic (scheduler semantics, no
        # wall-clock noise) — identical on every repeat by construction
        ttft_steps = [r.step_first_token - r.step_submitted
                      for r in ce.finished if r.step_first_token is not None]
        out[tag].update({
            "short_tpot_p99_ms": float(np.percentile(
                out[tag].pop("short_tpot_ms"), 99)),
            "ttft_p99_ms": float(np.percentile(out[tag].pop("ttft_ms"), 99)),
            "ttft_steps_p99": float(np.percentile(ttft_steps, 99)),
            "prefill_chunks": m["prefill_chunks"],
            "block_size": m["block_size"],
            "max_decode_stall_steps": m["max_decode_stall_steps"],
            "max_prefill_stall_tokens": m["max_prefill_stall_tokens"],
            "kv_gathered_bytes": m["kv_gathered_bytes"],
            "kv_touched_bytes": m["kv_touched_bytes"],
            "lost": m["lost"],
        })

    out["tpot_ratio"] = (out["chunked"]["short_tpot_p99_ms"]
                         / max(out["unchunked"]["short_tpot_p99_ms"], 1e-9))
    out["ttft_ratio"] = (out["chunked"]["ttft_p99_ms"]
                         / max(out["unchunked"]["ttft_p99_ms"], 1e-9))
    out["ttft_steps_ratio"] = (out["chunked"]["ttft_steps_p99"]
                               / max(out["unchunked"]["ttft_steps_p99"], 1e-9))
    out["stall_tokens_ratio"] = (
        out["chunked"]["max_prefill_stall_tokens"]
        / max(out["unchunked"]["max_prefill_stall_tokens"], 1e-9))
    out["streams_equal"] = (out["chunked"]["streams"]
                            == out["unchunked"]["streams"])
    for tag in ("unchunked", "chunked"):
        del out[tag]["streams"]
    out["decode_steps_total"] = steps_total
    print_fn(csv_line("serve/chunked_short_tpot_p99_ms",
                      out["chunked"]["short_tpot_p99_ms"],
                      f"unchunked={out['unchunked']['short_tpot_p99_ms']:.2f} "
                      f"ratio={out['tpot_ratio']:.2f} (wall, reference)"))
    print_fn(csv_line("serve/chunked_ttft_p99_ms",
                      out["chunked"]["ttft_p99_ms"],
                      f"unchunked={out['unchunked']['ttft_p99_ms']:.2f} "
                      f"ratio={out['ttft_ratio']:.2f} (wall, reference)"))
    print_fn(csv_line("serve/chunked_ttft_steps_p99",
                      out["chunked"]["ttft_steps_p99"],
                      f"unchunked={out['unchunked']['ttft_steps_p99']:.0f} "
                      f"ratio={out['ttft_steps_ratio']:.3f} (gate <= 1.10)"))
    print_fn(csv_line("serve/chunked_prefill_stall_tokens",
                      out["chunked"]["max_prefill_stall_tokens"],
                      f"unchunked="
                      f"{out['unchunked']['max_prefill_stall_tokens']} "
                      f"(gate: chunked < unchunked — running-slot stall "
                      f"bounded by the chunk, not the prompt)"))
    print_fn(csv_line("serve/chunked_prefill_chunks",
                      out["chunked"]["prefill_chunks"],
                      f"chunk={PREFILL_CHUNK} stall="
                      f"{out['chunked']['max_decode_stall_steps']} "
                      f"streams_equal={out['streams_equal']}"))
    print_fn(csv_line(
        "serve/chunked_kv_touched_mb",
        out["chunked"]["kv_touched_bytes"] / 1e6,
        f"gathered={out['chunked']['kv_gathered_bytes'] / 1e6:.1f}MB "
        f"(decode kernel reads live blocks only)"))
    return out


if __name__ == "__main__":
    import os

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args().device
    if os.path.exists(TUNING_CACHE):
        os.unlink(TUNING_CACHE)
    out = run(device=device)
    print(f"\ncontinuous vs lockstep speedup: {out['speedup']:.2f}x "
          f"(gate >= 1.0)")
    chunked = run_chunked(device=device)
    print(f"chunked prefill: ttft steps ratio="
          f"{chunked['ttft_steps_ratio']:.3f} (gate <= 1.10) "
          f"stall tokens {chunked['chunked']['max_prefill_stall_tokens']} vs "
          f"{chunked['unchunked']['max_prefill_stall_tokens']} "
          f"(gate: chunked < unchunked)")
    chaos = run_chaos(device=device)
    print(f"chaos: lost={chaos['chaos_lost']} "
          f"terminal={chaos['chaos_terminal']}/{chaos['n_requests']} "
          f"goodput ratio={chaos['goodput_ratio']:.2f} (gate >= 0.25)")
