"""Both packages' serving engines on reduced qwen3-4b with the same f32
parameters and the same greedy requests: token streams must be identical
and the engines' counters equal — plain requests, ragged prompts,
chunked prefill and a small pool that forces preemption; plus the
lockstep ``ServeEngine``.

The reference runs with ``REPRO_AUTOTUNE=0`` and an explicit block size
(so both use the same tilings) and with its paged decode as its kernel
computes it (``REPRO_PAGED_DECODE=interpret``: f32 probabilities, like
the port's kernel and plain version).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import transformer as JT
from repro.serve import ContinuousConfig as JConfig
from repro.serve import ContinuousEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.serve import (
    ContinuousConfig,
    ContinuousEngine,
    FaultPlan,
    Fault,
    Request,
    ServeConfig,
    ServeEngine,
)

COUNTS = ("finished", "refused", "expired", "lost", "decode_steps",
          "preemptions", "resumes", "prefill_chunks")


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_PAGED_DECODE", "interpret")


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config("qwen3-4b", reduced=True)
    tcfg = get_config("qwen3-4b", reduced=True)
    tree = JT.init_params(jcfg, 0)
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)), tree)
    tp = params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
    return jcfg, tcfg, jp, tp


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 512, (n,)).astype(np.int32) for n in lens]


def _streams(engine):
    return sorted((tuple(r.prompt.tolist()), tuple(r.tokens))
                  for r in engine.finished)


CASES = {
    "plain": ((9, 9, 9, 9), dict(max_len=64, n_slots=3, block_size=16)),
    "ragged": ((5, 21, 37, 12, 30), dict(max_len=64, n_slots=3, block_size=16)),
    "chunked": ((5, 21, 37, 12, 30),
                dict(max_len=64, n_slots=3, block_size=16, prefill_chunk=8)),
    "preempt": ((5, 21, 37, 12, 30),
                dict(max_len=64, n_slots=3, block_size=8, pool_tokens=48)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_continuous_streams_and_counts_match(model, case):
    jcfg, tcfg, jp, tp = model
    lens, kw = CASES[case]
    prompts = _prompts(lens)
    jeng = JEngine(jcfg, jp, JConfig(**kw))
    jeng.run([JRequest(p, max_new_tokens=6) for p in prompts])
    teng = ContinuousEngine(tcfg, tp, ContinuousConfig(**kw), device="cpu")
    teng.run([Request(p, max_new_tokens=6) for p in prompts])
    assert _streams(teng) == _streams(jeng)
    jm, tm = jeng.metrics(), teng.metrics()
    assert {k: tm[k] for k in COUNTS} == {k: jm[k] for k in COUNTS}
    assert tm["lost"] == 0 and tm["finished"] == len(prompts)
    if case == "chunked":
        assert tm["prefill_chunks"] > 0
    if case == "preempt":
        assert tm["preemptions"] > 0 and tm["resumes"] > 0


def test_injected_alloc_faults_keep_streams(model):
    """Seeded allocation faults delay admissions and growth but change no
    greedy stream (the port's fault plan drives the same code paths)."""
    _, tcfg, _, tp = model
    prompts = _prompts((5, 21, 37, 12, 30))
    kw = dict(max_len=64, n_slots=3, block_size=8, pool_tokens=48)
    base = ContinuousEngine(tcfg, tp, ContinuousConfig(**kw), device="cpu")
    base.run([Request(p, max_new_tokens=6) for p in prompts])
    faults = FaultPlan([Fault(s, "alloc", count=2) for s in (1, 3, 4, 9)])
    eng = ContinuousEngine(tcfg, tp, ContinuousConfig(**kw), faults=faults,
                           device="cpu")
    eng.run([Request(p, max_new_tokens=6) for p in prompts])
    assert _streams(eng) == _streams(base)
    assert eng.metrics()["lost"] == 0 and faults.fired["alloc"] > 0


def test_lockstep_engine_streams_match(model):
    jcfg, tcfg, jp, tp = model
    prompts = _prompts((7, 3, 12))
    j = JServeEngine(jcfg, jp, JServeConfig(max_len=32, n_slots=4)).generate(
        prompts, max_new_tokens=6)
    t = ServeEngine(tcfg, tp, ServeConfig(max_len=32, n_slots=4),
                    device="cpu").generate(prompts, max_new_tokens=6)
    np.testing.assert_array_equal(t["tokens"], j["tokens"])
    np.testing.assert_array_equal(t["token_counts"], j["token_counts"])
    assert t["decode_steps"] == j["decode_steps"]


def test_cost_engine_waits_for_its_port(model):
    _, tcfg, _, tp = model
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousEngine(tcfg, tp, cost_engine=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(tcfg, tp, cost_engine=object(), device="cpu")
