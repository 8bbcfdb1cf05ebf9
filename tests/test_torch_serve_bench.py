"""The port's serving benchmark (``repro_torch.bench.serve_bench``) against
the reference's (``benchmarks/serve_bench.py``) on the CPU, on reduced
internlm2-1.8b with the same f32 parameters in both packages (the
reference runs its paged decode as its kernel computes it,
``REPRO_PAGED_DECODE=interpret``, with tuning pinned, as in
``tests/test_torch_serve.py``).

* ``make_trace`` is the reference's, arrival for arrival;
* each request's greedy stream equals the reference's: the lockstep
  engine's on every batch the port's open-loop replay formed, the
  continuous engine's request by request (the replays batch by wall
  clock, so the batches themselves may differ between runs);
* the chunked row's step-count metrics (step-indexed TTFT, chunks, stalls)
  and ``kv_*_bytes`` equal the reference's;
* ``run`` and the chaos row hold their invariants, and the paged pool's
  block size is the one the reference's tuner resolves; the chaos row
  replays its trace on engine steps (``run_stepped``, where the
  reference's follows the wall clock), each request submitted before the
  step its arrival names;
* where the tuner picks a block of the whole window (a device spec at
  full width), the reference's pool leaves half the slots idle and its
  whole prefills stall running slots for a block; the port's engine fits
  the block to the pool and pads a prefill to a power of two instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import serve_bench as ref_bench
from repro.configs.registry import get_config as jax_config
from repro.models import transformer as JT
from repro.serve import ContinuousConfig as JConfig
from repro.serve import ContinuousEngine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bench import serve_bench
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.autotune import KernelTuner
from repro_torch.serve import (
    ContinuousConfig,
    ContinuousEngine,
    ServeConfig,
    PagedKVCache,
    ServeEngine,
    fit_block_size,
    resolve_block_size,
)
from tests._torch_host import port_host_share  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_PAGED_DECODE", "interpret")


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config("internlm2-1.8b", reduced=True)
    tcfg = get_config("internlm2-1.8b", reduced=True)
    tree = JT.init_params(jcfg, 0)
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)), tree)
    tp = params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_trace_is_the_reference(seed):
    mine, ref = serve_bench.make_trace(seed), ref_bench.make_trace(seed)
    assert len(mine) == len(ref) == serve_bench.N_REQUESTS
    for (a, p, m), (ra, rp, rm) in zip(mine, ref):
        assert a == ra and m == rm and p.dtype == rp.dtype
        assert np.array_equal(p, rp)


def test_constants_are_the_reference():
    for name in ("MAX_LEN", "N_SLOTS", "N_REQUESTS", "RATE_RPS", "PROMPT_LENS",
                 "MAX_NEW", "GOODPUT_TPOT_MS", "CHAOS_POOL_TOKENS",
                 "CHAOS_FAULT_STEPS", "CHAOS_P_ALLOC", "CHAOS_P_BACKEND",
                 "CHAOS_DEADLINE_MS", "CHUNK_MAX_LEN", "CHUNK_SLOTS", "CHUNK_SHORT",
                 "CHUNK_LONG", "CHUNK_SHORT_NEW", "CHUNK_LONG_NEW", "PREFILL_CHUNK",
                 "CHUNK_REPEATS"):
        assert getattr(serve_bench, name) == getattr(ref_bench, name), name
    for mine, ref in zip(sum(serve_bench._chunked_prompts(), []),
                         sum(ref_bench._chunked_prompts(), [])):
        assert np.array_equal(mine, ref)


def test_block_size_is_the_reference_tuner_s(model, tmp_path):
    from repro.kernels.autotune import KernelTuner as RefTuner
    from repro.serve import resolve_block_size as ref_resolve

    jcfg, tcfg, _, _ = model
    kw = dict(n_slots=serve_bench.N_SLOTS, max_len=serve_bench.MAX_LEN)
    mine = resolve_block_size(tcfg, **kw, tuner=KernelTuner(cache=str(tmp_path / "a.json")))
    ref = ref_resolve(jcfg, **kw, tuner=RefTuner(cache=str(tmp_path / "b.json")))
    assert mine == ref
    # on the host's spec the pool already holds a block for every slot
    assert fit_block_size(mine, **kw) == mine


@pytest.mark.parametrize("max_len,picked,fitted", [
    (serve_bench.MAX_LEN, 64, 32),
    (serve_bench.CHUNK_MAX_LEN, 128, 64),
])
def test_full_width_block_fits_the_pool_where_the_reference_s_does_not(
        max_len, picked, fitted):
    """Full-width internlm2-1.8b under a device spec (the reference's
    ``tpu_v5e`` and the port's ``h100`` pick alike): the tuner's block is
    the whole window, so the reference's default pool has 2 blocks for 4
    slots; the fitted block gives every slot one, in a pool still smaller
    than the dense cache."""
    from repro.engine import get_device as ref_device
    from repro.kernels.autotune import KernelTuner as RefTuner
    from repro.serve import PagedKVCache as RefCache
    from repro.serve import resolve_block_size as ref_resolve
    from repro_torch.engine import get_device

    n = serve_bench.N_SLOTS
    jcfg, tcfg = jax_config("internlm2-1.8b"), get_config("internlm2-1.8b")
    ref = ref_resolve(jcfg, n_slots=n, max_len=max_len,
                      tuner=RefTuner(device=ref_device("tpu_v5e"), measure=False))
    for spec in ("tpu_v5e", "h100"):
        mine = resolve_block_size(tcfg, n_slots=n, max_len=max_len,
                                  tuner=KernelTuner(device=get_device(spec), measure=False))
        assert mine == ref == picked, spec
    assert RefCache(jcfg, n_slots=n, max_len=max_len, block_size=ref).usable_blocks == 2 < n
    bs = fit_block_size(ref, n_slots=n, max_len=max_len)
    assert bs == fitted
    pool = PagedKVCache(tcfg, n_slots=n, max_len=max_len, block_size=bs, device="cpu")
    assert pool.usable_blocks == n and pool.bytes < pool.dense_bytes


def test_engine_fits_the_tuner_s_block_and_honours_a_given_one(model, monkeypatch,
                                                               tmp_path):
    from repro_torch.engine import get_device
    from repro_torch.kernels import autotune

    _, tcfg, _, tp = model
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    previous = autotune.get_tuner()
    autotune.set_tuner(KernelTuner(get_device("tpu_v5e"), cache=str(tmp_path / "t.json"),
                                   measure=False))
    try:
        L, n = serve_bench.MAX_LEN, serve_bench.N_SLOTS
        assert resolve_block_size(tcfg, n_slots=n, max_len=L) == L

        def engine(**kw):
            return ContinuousEngine(tcfg, tp, ContinuousConfig(
                max_len=L, n_slots=n, eos_id=0, **kw), device="cpu")
        fitted = engine()
        assert fitted.kv.block_size == L // 2 and fitted.kv.usable_blocks == n
        assert engine(block_size=L).kv.block_size == L
    finally:
        autotune.set_tuner(previous)


def test_no_prefill_step_is_wider_than_a_chunk_at_a_block_of_the_window(model):
    """The chunked row's engines at a block of the whole window (the card
    tuner's pick at full width): the reference's engine pads the short
    prompts' whole prefills to the block, 128 tokens, while others decode;
    the port's pads them to 16, so the stall is one chunk, and chunking
    leaves the streams as they were."""
    jcfg, tcfg, jp, tp = model
    shorts, longs = serve_bench._chunked_prompts()
    kw = dict(max_len=serve_bench.CHUNK_MAX_LEN, n_slots=serve_bench.CHUNK_SLOTS, eos_id=0,
              block_size=serve_bench.CHUNK_MAX_LEN, seed=0)
    streams, stall = {}, {}
    for chunk in (None, serve_bench.PREFILL_CHUNK):
        mine = ContinuousEngine(tcfg, tp, ContinuousConfig(**kw, prefill_chunk=chunk),
                                device="cpu")
        serve_bench._run_chunked_pass(mine, shorts, longs)
        streams[chunk] = sorted(tuple(r.tokens) for r in mine.finished)
        stall[chunk] = mine.max_prefill_stall_tokens
    ref = JEngine(jcfg, jp, JConfig(**kw, prefill_chunk=serve_bench.PREFILL_CHUNK))
    ref_bench._run_chunked_pass(ref, shorts, longs)
    assert ref.max_prefill_stall_tokens == serve_bench.CHUNK_MAX_LEN
    assert stall[serve_bench.PREFILL_CHUNK] == serve_bench.PREFILL_CHUNK < stall[None]
    assert streams[None] == streams[serve_bench.PREFILL_CHUNK]


def test_lockstep_streams_are_the_reference(model, monkeypatch):
    jcfg, tcfg, jp, tp = model
    scfg = dict(max_len=serve_bench.MAX_LEN, n_slots=serve_bench.N_SLOTS, eos_id=0)
    eng = ServeEngine(tcfg, tp, ServeConfig(**scfg), device="cpu")
    batches = []
    generate = eng.generate

    def recording(prompts, max_new_tokens):
        out = generate(prompts, max_new_tokens=max_new_tokens)
        batches.append((prompts, max_new_tokens, out))
        return out

    monkeypatch.setattr(eng, "generate", recording)
    trace = serve_bench.make_trace(0)
    res = serve_bench.run_lockstep(eng, trace)
    assert len(res["done"]) == len(trace) and res["wall_s"] > 0
    ref = JServeEngine(jcfg, jp, JServeConfig(**scfg))
    for prompts, max_new, out in batches:
        want = ref.generate(prompts, max_new_tokens=max_new)
        assert [list(o) for o in out["outputs"]] == [list(o) for o in want["outputs"]]
        assert list(out["token_counts"]) == list(want["token_counts"])


def _streams(ce) -> dict:
    return {(tuple(int(t) for t in r.prompt), r.max_new_tokens): list(r.tokens)
            for r in ce.finished}


def test_continuous_streams_are_the_reference(model):
    jcfg, tcfg, jp, tp = model
    kw = dict(max_len=serve_bench.MAX_LEN, n_slots=serve_bench.N_SLOTS, eos_id=0,
              block_size=16)
    trace = serve_bench.make_trace(0)
    mine = ContinuousEngine(tcfg, tp, ContinuousConfig(**kw), device="cpu")
    serve_bench.run_continuous(mine, trace)
    ref = JEngine(jcfg, jp, JConfig(**kw))
    ref_bench.run_continuous(ref, trace)
    got, want = _streams(mine), _streams(ref)
    assert len(got) == len(trace) and got == want


def test_chunked_step_metrics_are_the_reference(model, monkeypatch):
    jcfg, tcfg, jp, tp = model
    monkeypatch.setattr(ref_bench.T, "init_params", lambda cfg, seed: jp)
    mine_lines, ref_lines = [], []
    mine = serve_bench.run_chunked(mine_lines.append, device="cpu", cfg=tcfg, params=tp)
    ref = ref_bench.run_chunked(ref_lines.append)
    for tag in ("unchunked", "chunked"):
        for k in ("ttft_steps_p99", "prefill_chunks", "max_decode_stall_steps",
                  "max_prefill_stall_tokens", "kv_gathered_bytes", "kv_touched_bytes",
                  "lost"):
            assert mine[tag][k] == ref[tag][k], (tag, k)
    for k in ("ttft_steps_ratio", "stall_tokens_ratio", "streams_equal"):
        assert mine[k] == ref[k], k
    assert mine["streams_equal"] and mine["chunked"]["prefill_chunks"] > 0
    assert mine["decode_steps_total"] > 0
    assert [ln.split(",")[0] for ln in mine_lines] == [ln.split(",")[0] for ln in ref_lines]
    steps = [ln for ln in ref_lines if "ttft_steps_p99" in ln or "stall_tokens" in ln]
    assert [ln for ln in mine_lines if "ttft_steps_p99" in ln or "stall_tokens" in ln] \
        == steps


def test_stepped_replay_submits_each_request_before_its_step(model):
    """``run_stepped`` submits the request arriving at t s just before
    engine step ⌊t / CHAOS_STEP_S⌋ + 1, whatever the host's speed, and the
    engine serves every request."""
    _, tcfg, _, tp = model
    trace = serve_bench.make_trace(0)
    ce = ContinuousEngine(tcfg, tp, ContinuousConfig(
        max_len=serve_bench.MAX_LEN, n_slots=serve_bench.N_SLOTS, eos_id=0,
        block_size=16), device="cpu")
    submitted = []
    submit = ce.submit
    ce.submit = lambda req: submitted.append(ce._step) or submit(req)
    serve_bench.run_stepped(ce, trace)
    assert submitted == [int(a // serve_bench.CHAOS_STEP_S) for a, _, _ in trace]
    assert len(ce.finished) == len(trace) and ce.idle


def test_run_and_chaos_hold_their_invariants(model):
    _, tcfg, _, tp = model
    lines = []
    out = serve_bench.run(lines.append, device="cpu", cfg=tcfg, params=tp)
    assert out["n_requests"] == serve_bench.N_REQUESTS
    assert out["lockstep_rps"] > 0 and out["continuous_rps"] > 0
    assert all(np.isfinite(out[k]) and out[k] > 0 for k in
               ("ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms", "tpot_p99_ms"))
    assert out["kv_bytes"] < out["kv_dense_bytes"]
    assert out["decode_steps_total"] > out["decode_steps"] > 0
    assert [ln.split(",")[0] for ln in lines][:2] == ["serve/lockstep_rps",
                                                      "serve/continuous_rps"]
    chaos = serve_bench.run_chaos(lines.append, device="cpu", cfg=tcfg, params=tp)
    assert chaos["chaos_lost"] == chaos["baseline_lost"] == 0
    assert chaos["chaos_terminal"] == chaos["n_requests"]
    assert chaos["faults_alloc_fired"] > 0 and chaos["faults_backend_fired"] > 0
    assert chaos["pool_conserved"] and chaos["decode_steps_total"] > 0
