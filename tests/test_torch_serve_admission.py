"""SLO serve admission of the port (``SLOScheduler``, ``FailoverChain``,
``ContinuousEngine`` and ``ServeEngine`` with a cost engine) against the
reference's, on the reference's own scenarios (``tests/test_serve.py``
scheduler tests, ``tests/test_energy.py``'s energy-budget refusal,
``tests/test_robustness.py``'s failover tests).

Every scenario runs in both packages with the same stub forests
(``_FakeLMForest``: constant Γ/Φ; ``_BsFakeLMForest``: Γ linear in the
priced batch size) behind each package's ``CostEngine``.  The decision
path is numpy only, so decisions, refusal messages and ``info`` dicts,
deferral schedules, counters, ``FailoverChain`` metrics under the same
``FaultPlan``, and the greedy token streams of reduced qwen3-4b under
admission are held equal, exactly.  The reference runs its paged decode
as its kernel computes it (``REPRO_PAGED_DECODE=interpret``) and both run
with ``REPRO_AUTOTUNE=0``, as in ``tests/test_torch_serve.py``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.engine as ref_engine
import repro.serve as ref_serve
import repro_torch.engine as port_engine
import repro_torch.serve as port_serve
from repro.configs.registry import get_config as jax_config
from repro.models import transformer as JT
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

PKG = {"port": types.SimpleNamespace(engine=port_engine, serve=port_serve, config=get_config),
       "ref": types.SimpleNamespace(engine=ref_engine, serve=ref_serve, config=jax_config)}


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_PAGED_DECODE", "interpret")


@pytest.fixture(scope="module")
def model():
    """Reduced qwen3-4b with the same f32 parameters in both packages."""
    tree = JT.init_params(jax_config("qwen3-4b", reduced=True), 0)
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)), tree)
    tcfg = get_config("qwen3-4b", reduced=True)
    return {"ref": (jax_config("qwen3-4b", reduced=True), jp),
            "port": (tcfg, params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32))}


def _engine_kw(pkg):
    return {"device": "cpu"} if pkg == "port" else {}


class _FakeLMForest:
    """Fitted-forest stand-in: constant (Γ, Φ) per query, nothing traced."""

    fitted = True
    meta: dict = {}

    def __init__(self, get_device, gamma_mb, phi_ms=1.0):
        self.gamma_mb, self.phi_ms = gamma_mb, phi_ms
        self.default_device = get_device("host_cpu")
        self.calls = 0

    def content_hash(self):
        return f"fake-{self.gamma_mb}-{self.phi_ms}"

    def predict_queries(self, queries):
        self.calls += 1
        n = len(queries)
        return np.full(n, self.gamma_mb), np.full(n, self.phi_ms)


class _BsFakeLMForest(_FakeLMForest):
    """Batch-sensitive stand-in: Γ grows linearly with the priced bs."""

    def content_hash(self):
        return f"bsfake-{self.gamma_mb}-{self.phi_ms}"

    def predict_queries(self, queries):
        self.calls += 1
        return (np.array([self.gamma_mb * q.bs for q in queries]),
                np.full(len(queries), self.phi_ms))


def _cost_engine(pkg, forest_cls, *args):
    E = PKG[pkg].engine
    return E.CostEngine(E.ForestBackend(lm=forest_cls(E.get_device, *args)))


def _scheduler(pkg, forest_cls, gamma_mb, budget_mb, phi_ms=1.0, **kw):
    S = PKG[pkg].serve
    if "slo" in kw:
        kw["slo"] = S.ServeSLO(**kw["slo"])
    return S.SLOScheduler(PKG[pkg].config("internlm2-1.8b", reduced=True),
                          _cost_engine(pkg, forest_cls, gamma_mb, phi_ms),
                          max_len=64, n_slots=4, gamma_budget_mb=budget_mb, **kw)


def _request(pkg, n=8, new=8, start=1, **kw):
    return PKG[pkg].serve.Request(prompt=np.arange(start, start + n, dtype=np.int32),
                                  max_new_tokens=new, **kw)


def _both(fn):
    """``fn(pkg)`` in both packages; returns (port, reference)."""
    return fn("port"), fn("ref")


def _decide(sched_args, req_kw, n_running, forest=_FakeLMForest, refusal=False):
    def run(pkg):
        sched = _scheduler(pkg, forest, *sched_args[:2], **sched_args[2])
        req = _request(pkg, **req_kw)
        dec, info = sched.admit(req, n_running=n_running)
        out = (dec.value, info)
        if refusal and dec.value == "refuse":
            err = sched.refusal(req, info)
            out += (type(err).__name__, str(err).replace(f"request {req.rid} ", "request # "),
                    err.info)
        return out

    mine, ref = _both(run)
    assert mine == ref
    return mine


# ---------------------------------------------------------------------------
# the scheduler's decisions (tests/test_serve.py:276-510, test_energy.py:397)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gamma_mb, want", [(500.0, "refuse"), (50.0, "admit")])
def test_scheduler_cost_driven_without_a_trace(monkeypatch, gamma_mb, want):
    """Over-budget composition refused, fitting one admitted — and the
    decision path with a fitted forest never traces a step."""
    def boom(*a, **k):
        raise AssertionError("admission path traced a step")

    monkeypatch.setattr(port_engine.AnalyticalBackend, "_trace_arch", boom)
    dec, info = _decide((gamma_mb, 100.0, {}), {}, 1, refusal=True)[:2]
    assert dec == want and info["bs"] == 2 and info["source"] == "forest"
    if want == "refuse":
        assert "budget" in info["reason"]
    else:
        assert info["gamma_eff"] == pytest.approx(55.0)


@pytest.mark.parametrize("energy", [False, True])
def test_scheduler_refusal_carries_ledger_breakdown(energy):
    """A refusal carries the estimate's ``cost_classes`` (scalar buckets,
    or ``class_sums`` dicts with an energy budget), its message names the
    top classes, as in the reference."""
    def run(pkg):
        E, S = PKG[pkg].engine, PKG[pkg].serve
        if energy:
            detail = {"cost_classes": {"matmul": {"flops": 1.0, "hbm_bytes": 2.0,
                                                  "collective_bytes": 0.0,
                                                  "energy_j": 30.0, "count": 3}},
                      "energy_classes": {"matmul": 30.0, "elementwise": 10.0}}
            est = E.CostEstimate(gamma_mb=10.0, phi_ms=5.0, energy_j=40.0,
                                 source="analytical", detail=detail)
            kw = dict(gamma_budget_mb=1e6, energy_budget_j=20.0)
        else:
            est = E.CostEstimate(gamma_mb=900.0, phi_ms=5.0, source="analytical",
                                 detail={"cost_classes": {"matmul": 700.0,
                                                          "elementwise": 150.0,
                                                          "collective": 50.0}})
            kw = dict(gamma_budget_mb=100.0)
        engine = types.SimpleNamespace(estimate_one=lambda q: est)
        sched = S.SLOScheduler(PKG[pkg].config("internlm2-1.8b", reduced=True), engine,
                               max_len=64, n_slots=4, **kw)
        req = _request(pkg, n=5, new=4)
        dec, info = sched.admit(req, n_running=0)
        err = sched.refusal(req, info)
        return dec.value, info, str(err).split("refused: ")[1], err.info

    mine, ref = _both(run)
    assert mine == ref and mine[0] == "refuse"
    assert ("energy" in mine[1]["reason"]) == energy and "matmul=" in mine[2]


@pytest.mark.parametrize("case", ["window", "slo_refuse", "slo_admit"])
def test_scheduler_slo_and_window_refusals(case):
    if case == "window":
        dec, info = _decide((10.0, 1e6, {}), dict(n=59, new=32), 0)
        assert dec == "refuse" and "max_len" in info["reason"]
    else:
        slo = 1.0 if case == "slo_refuse" else 100.0
        dec, info = _decide((10.0, 1e6, {"phi_ms": 640.0}), dict(slo_ms=slo), 0,
                            refusal=True)[:2]
        assert dec == ("refuse" if case == "slo_refuse" else "admit")
        assert info["tpot_proxy_ms"] == pytest.approx(11.0)


@pytest.mark.parametrize("ttft, want", [(50.0, "refuse"), (200.0, "admit")])
def test_scheduler_ttft_slo_refusal(ttft, want):
    dec, info = _decide((10.0, 1e6, {"phi_ms": 100.0, "slo": {"ttft_ms": ttft}}), {}, 0)
    assert dec == want and info["ttft_proxy_ms"] == pytest.approx(110.0)


@pytest.mark.parametrize("gamma, running, want", [(60.0, 1, "defer"), (60.0, 0, "admit"),
                                                  (120.0, 1, "refuse")])
def test_scheduler_defers_occupancy_transient_misses(gamma, running, want):
    dec, info = _decide((gamma, 100.0, {}), {}, running, forest=_BsFakeLMForest)
    assert dec == want
    assert ("defer" in info) == (want == "defer")


def test_scheduler_backend_unavailable_admits_ungated():
    def run(pkg):
        E = PKG[pkg].engine

        def unavailable(q):
            raise E.BackendUnavailable("cannot score this arch")

        sched = PKG[pkg].serve.SLOScheduler(
            PKG[pkg].config("internlm2-1.8b", reduced=True),
            types.SimpleNamespace(estimate_one=unavailable), max_len=64, n_slots=4,
            gamma_budget_mb=1.0)
        dec, info = sched.admit(_request(pkg), n_running=0)
        return dec.value, info, sched.unavailable

    mine, ref = _both(run)
    assert mine == ref and mine[0] == "admit" and "skipped" in mine[1]


def test_scheduler_price_buckets_and_device_budget():
    """``price`` attaches the bs=1 estimate; a device-carrying engine's
    capacity is the default budget."""
    def run(pkg):
        E, S = PKG[pkg].engine, PKG[pkg].serve
        engine = E.CostEngine(E.ForestBackend(lm=_BsFakeLMForest(E.get_device, 7.0)),
                              device="tpu_v5e")
        sched = S.SLOScheduler(PKG[pkg].config("qwen3-4b", reduced=True), engine,
                               max_len=512, n_slots=4)
        req = _request(pkg, n=100, new=30)
        est = sched.price(req)
        dec, info = sched.admit(req, n_running=2)
        return (sched.arch, sched.reduced, sched.gamma_budget_mb, est.to_dict(),
                req.estimate.gamma_mb, dec.value, info, engine.hits, engine.misses)

    mine, ref = _both(run)
    assert mine == ref and mine[:3] == ("qwen3-4b", True, 16e3)


# ---------------------------------------------------------------------------
# FailoverChain (tests/test_robustness.py:140-250)
# ---------------------------------------------------------------------------


class _Flaky:
    """A backend that crashes (a real exception, not BackendUnavailable)
    until healed; ``answer`` is its Γ and Φ."""

    def __init__(self, E, name="flaky", fail=True, answer=1.0):
        self.E, self.name, self.fail, self.answer, self.calls = E, name, fail, answer, 0

    def supports(self, query):
        return True

    def cache_salt(self):
        return self.name

    def estimate(self, queries):
        self.calls += 1
        if self.fail:
            raise RuntimeError("poisoned forest file")
        return [self.E.CostEstimate(gamma_mb=self.answer, phi_ms=self.answer,
                                    source=self.name) for _ in queries]


def _query(pkg):
    return PKG[pkg].engine.CostQuery(arch="internlm2-1.8b", bs=1, seq=64, stage="infer",
                                     reduced=True)


def test_failover_chain_steps_down_and_probe_recovers():
    def run(pkg):
        E, S = PKG[pkg].engine, PKG[pkg].serve
        flaky, steady = _Flaky(E), _Flaky(E, "steady", fail=False, answer=2.0)
        fc = S.FailoverChain(E.CostEngine(E.EnsembleBackend([flaky, steady])),
                             fail_threshold=2, probe_every=3)
        trail = [fc.health.levels]
        for i in range(10):        # probes on calls 3, 6, 9; healed before call 9
            if i == 6:
                flaky.fail = False
            est = fc.estimate_one(_query(pkg))
            trail.append((est.source, fc.metrics(), flaky.calls, steady.calls))
        return trail

    mine, ref = _both(run)
    assert mine == ref
    assert mine[0] == ["flaky", "steady", "static"] and mine[-1][0] == "flaky"
    assert mine[-1][1]["recoveries"] == 1


def test_failover_chain_exhausts_to_static_and_passes_unavailable_through():
    def run(pkg):
        E, S = PKG[pkg].engine, PKG[pkg].serve
        fc = S.FailoverChain(E.CostEngine(E.EnsembleBackend([_Flaky(E), _Flaky(E)])),
                             fail_threshold=1, probe_every=100)
        out = [fc.estimate_one(_query(pkg)), fc.degraded, fc.metrics()]

        class _Unavail:
            name = "unavail"

            def supports(self, query):
                return True

            def estimate(self, queries):
                raise E.BackendUnavailable("cannot score this arch")

        fc2 = S.FailoverChain(E.CostEngine(_Unavail()))
        with pytest.raises(E.BackendUnavailable):
            fc2.estimate_one(_query(pkg))
        return out + [fc2.metrics()]

    mine, ref = _both(run)
    assert mine == ref and mine[0] is None and mine[1] and mine[2]["failovers"] == 2


def test_scheduler_degraded_static_budget():
    def run(pkg):
        E, S = PKG[pkg].engine, PKG[pkg].serve
        eng = E.CostEngine(E.EnsembleBackend([_Flaky(E)]))
        fc = S.FailoverChain(eng, fail_threshold=1, probe_every=1000)
        sched = S.SLOScheduler(PKG[pkg].config("internlm2-1.8b", reduced=True), eng,
                               max_len=64, n_slots=4, gamma_budget_mb=1e6, failover=fc,
                               degraded_slots=2)
        req = _request(pkg, new=4)
        return [(d.value, info) for d, info in
                (sched.admit(req, n_running=0), sched.admit(req, n_running=2))]

    mine, ref = _both(run)
    assert mine == ref
    assert mine[0][0] == "admit" and mine[0][1]["health"] == "static"
    assert mine[1][0] == "defer" and "static" in mine[1][1]["reason"]


# ---------------------------------------------------------------------------
# the engines under admission: streams, counters, refusals
# ---------------------------------------------------------------------------


COUNTS = ("finished", "refused", "expired", "submitted", "lost", "decode_steps",
          "preemptions", "resumes", "defer_backoffs", "alloc_denied", "failovers",
          "degraded_steps", "prefill_chunks", "shed_backpressure")


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 512, (n,)).astype(np.int32) for n in lens]


def _serve(model, pkg, scfg_kw, engine, requests, faults=None):
    S = PKG[pkg].serve
    cfg, params = model[pkg]
    ce = S.ContinuousEngine(cfg, params, S.ContinuousConfig(**scfg_kw), cost_engine=engine,
                            faults=faults, **_engine_kw(pkg))
    reqs = [S.Request(p, max_new_tokens=m, **kw) for p, m, kw in requests]
    trail = []
    for r in reqs:
        ce.submit(r)
    while not ce.idle:
        ce.step()
        trail.append((ce.n_running, len(ce.queue)))
    m = ce.metrics()
    return {"streams": [(r.state.value, list(r.tokens)) for r in reqs],
            "refusals": [str(r.refusal).split("refused: ")[1] if r.refusal else None
                         for r in reqs],
            "retries": [(r.defer_retries, r.retry_at_step) for r in reqs],
            "counts": {k: m[k] for k in COUNTS}, "health": m.get("health"),
            "trail": trail}


@pytest.mark.parametrize("case", ["defer", "refuse", "window", "energy_slo"])
def test_continuous_engine_under_admission_as_reference(model, case):
    """The gated ``ContinuousEngine`` of both packages on the same requests:
    DEFER backoffs (Γ linear in bs, a budget of two slots' worth), a
    refusal of every request, an oversized prompt refused by the engine's
    own window check before the scheduler, and per-request SLO and energy
    gates — streams, refusal messages, retry schedules, counters and the
    per-step occupancy equal."""
    lens = (5, 21, 37, 12, 30)
    kw = dict(max_len=64, n_slots=3, block_size=16)
    forest, gamma = _BsFakeLMForest, 40.0
    reqs = [(p, 6, {}) for p in _prompts(lens)]
    if case == "defer":
        kw.update(gamma_budget_mb=100.0, prefill_chunk=8)
    elif case == "refuse":
        forest, gamma = _FakeLMForest, 5000.0
        kw.update(gamma_budget_mb=100.0)
    elif case == "window":
        kw.update(gamma_budget_mb=1e6)
        reqs.insert(1, (_prompts((60,))[0], 8, {}))
    else:
        kw.update(gamma_budget_mb=1e6, energy_budget_j=5.0)
        reqs[2] = (reqs[2][0], 6, {"slo_ms": 0.01})
    mine, ref = _both(lambda pkg: _serve(model, pkg, kw,
                                         _cost_engine(pkg, forest, gamma, 1.0), reqs))
    if case == "defer":
        # the 5-token prompt fits the chunk of 8 but pads to the block of
        # 16: the reference prefills it whole, the port in one chunk
        ref["counts"]["prefill_chunks"] += 1
    assert mine == ref
    c = mine["counts"]
    assert c["lost"] == 0 and c["finished"] + c["refused"] == len(reqs)
    if case == "defer":
        assert c["defer_backoffs"] > 0 and max(n for n, _ in mine["trail"]) <= 2
    if case == "refuse":
        assert c["refused"] == len(reqs)
    if case == "window":
        assert "max_len" in mine["refusals"][1]
    if case == "energy_slo":
        assert c["refused"] == 1 and "SLO" in mine["refusals"][2]


def test_chaos_failover_under_the_same_fault_plan(model):
    """Seeded allocation and backend faults and a slow step through the
    gated engine: nothing escapes ``step``, every request ends, and the
    health metrics, counters and streams equal the reference's."""
    def run(pkg):
        S = PKG[pkg].serve
        plan = S.FaultPlan(
            [S.Fault(step=s, kind="alloc") for s in (1, 2, 4, 6, 8)]
            + [S.Fault(step=s, kind="backend") for s in (1, 2, 3, 4, 5)]
            + [S.Fault(step=3, kind="slow", delay_s=0.01)])
        reqs = [(p, m, {}) for p, m in zip(_prompts([4, 7, 3, 11, 6, 5], seed=5),
                                           (3, 10, 5, 2, 8, 4))]
        out = _serve(model, pkg, dict(max_len=64, n_slots=2, block_size=16, pool_tokens=96,
                                      gamma_budget_mb=1e6, health_fail_threshold=2),
                     _cost_engine(pkg, _FakeLMForest, 50.0), reqs, faults=plan)
        return out, plan.summary()

    mine, ref = _both(run)
    assert mine == ref
    out, faults = mine
    assert out["counts"]["lost"] == 0 and out["counts"]["alloc_denied"] > 0
    assert faults["fired"]["backend"] > 0 and out["health"]["failovers"] >= 1


def test_gated_engine_refuses_oversized_prompt_before_scheduler(model):
    def run(pkg):
        E, S = PKG[pkg].engine, PKG[pkg].serve
        calls = []

        def estimate_one(query):
            calls.append(query)
            return E.CostEstimate(gamma_mb=1.0, phi_ms=1.0, source="stub")

        cfg, params = model[pkg]
        ce = S.ContinuousEngine(cfg, params, S.ContinuousConfig(
            max_len=32, n_slots=2, block_size=16, gamma_budget_mb=1e6),
            cost_engine=types.SimpleNamespace(estimate_one=estimate_one),
            **_engine_kw(pkg))
        big = S.Request(prompt=np.arange(1, 41, dtype=np.int32), max_new_tokens=4)
        ce.run([big])
        return big.state.value, str(big.refusal).split("refused: ")[1], len(calls)

    mine, ref = _both(run)
    assert mine == ref and mine[0] == "refused" and mine[2] == 0


@pytest.mark.parametrize("case", ["admit", "refuse", "device", "unavailable"])
def test_lockstep_engine_admission_as_reference(model, case):
    """``ServeEngine``'s placement gate: an external engine that admits
    (then the same greedy tokens), one that refuses with the reference's
    ``PlacementRefused`` message, a device spec's capacity over a forest,
    and an engine that cannot score the arch (placement ungated)."""
    prompts = _prompts((7, 3, 12))

    def run(pkg):
        E, S = PKG[pkg].engine, PKG[pkg].serve
        cfg, params = model[pkg]
        kw = dict(max_len=32, n_slots=4)
        engine = _cost_engine(pkg, _BsFakeLMForest, 10.0)
        if case == "refuse":
            kw["gamma_budget_mb"] = 30.0
        elif case == "device":
            kw["device"] = E.DeviceSpec(name="small", peak_flops=1e12, hbm_bw=1e11,
                                        hbm_bytes=35e6)
        elif case == "unavailable":
            engine = E.CostEngine(E.ForestBackend())
        try:
            se = S.ServeEngine(cfg, params, S.ServeConfig(**kw), engine, **_engine_kw(pkg))
        except S.PlacementRefused as e:
            return "refused", str(e), e.info
        out = se.generate(prompts, max_new_tokens=5)
        return se.admission_info, out["tokens"].tolist()

    mine, ref = _both(run)
    assert mine == ref
    if case in ("refuse", "device"):
        assert mine[0] == "refused" and "predicted" in mine[1]
    elif case == "unavailable":
        assert "skipped" in mine[0]
    else:
        assert mine[0]["gamma_eff"] == pytest.approx(44.0)


def test_lockstep_engine_admits_through_the_analytical_trace(model):
    """With ``ServeConfig.device`` and no engine the port builds the
    reference's ``CostEngine(AnalyticalBackend(lm_device=…))`` and traces
    the served cell (reduced qwen3-4b at n_slots × max_len) on meta
    tensors: a roomy device admits, a tiny budget refuses."""
    cfg, params = model["port"]
    S = port_serve
    se = S.ServeEngine(cfg, params, S.ServeConfig(max_len=32, n_slots=4, device="h100"),
                       device="cpu")
    info = se.admission_info
    assert info["device"] == "h100" and info["source"] == "analytical"
    assert 0 < info["gamma_mb"] < 80e3
    with pytest.raises(S.PlacementRefused, match="predicted"):
        S.ServeEngine(cfg, params, S.ServeConfig(max_len=32, n_slots=4, device="h100",
                                                 gamma_budget_mb=0.01), device="cpu")
