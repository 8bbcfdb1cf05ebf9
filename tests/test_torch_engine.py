"""The port's cost engine against the reference's: query keys, the
estimate cache file, the forest, analytical and ensemble backends, the
engine's hits, misses, salts and flushes, ``HealthState`` and the
decomposition terms.

All of it is numpy, so it is held exactly (``==``), except the analytical
estimates under a calibrated spec, held at rel 1e-12 as stated where they
are compared.  ``ProfilerBackend`` measures, so it is held by definition:
finite, positive, the reference's ``detail`` keys.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from repro.core import dataset as ref_dataset
from repro.core import features as ref_features
from repro.core import predictor as ref_predictor
from repro.core import pruning as ref_pruning
from repro.engine import backends as ref_backends
from repro.engine import decompose as ref_decompose
from repro.engine import devices as ref_devices
from repro.engine import engine as ref_engine
from repro.engine import types as ref_types
from repro.engine.cache import EstimateCache as RefEstimateCache
from repro_torch.core import dataset, features, predictor, pruning
from repro_torch.engine import types as port_types
from repro_torch.engine import (
    AnalyticalBackend,
    BackendUnavailable,
    CostEngine,
    CostEstimate,
    CostQuery,
    EnsembleBackend,
    EstimateCache,
    ForestBackend,
    HealthState,
    ProfilerBackend,
    decompose,
    devices,
)
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

WM, HW = 0.25, 16
FAMILIES = ("resnet50", "mobilenetv2", "squeezenet")
LEVELS = (0.0, 0.5)


def _pair(family, level, strategy="random", seed=0, wm=WM, hw=HW):
    """(port model, reference model) of one pruned topology."""
    return (pruning.pruned_model(family, level, strategy, seed, width_mult=wm, input_hw=hw),
            ref_pruning.pruned_model(family, level, strategy, seed, width_mult=wm,
                                     input_hw=hw))


def _ref_dps(n=40, seed=0, family="squeezenet"):
    """Synthetic datapoints whose targets are smooth functions of the real
    features (tests/test_engine.py's recipe), as reference datapoints."""
    rng = np.random.default_rng(seed)
    dps = []
    for _ in range(n):
        level = float(rng.uniform(0, 0.9))
        bs = int(rng.integers(2, 33))
        m = ref_pruning.pruned_model(family, level, "uniform", seed=0,
                                     width_mult=WM, input_hw=HW)
        f = ref_features.network_features(m.conv_specs(), bs)
        dps.append(ref_dataset.Datapoint(
            family=family, level=level, strategy="uniform", bs=bs,
            width_mult=WM, input_hw=HW, seed=0,
            gamma_mb=5.0 + f[4] / 1e5, phi_ms=2.0 + f[14] / 1e7,
            features=[float(v) for v in f]))
    return dps


def _port_dps(ref_dps):
    return [dataset.Datapoint(**dataclasses.asdict(dp)) for dp in ref_dps]


@pytest.fixture(scope="module")
def predictors():
    """(port, reference) predictors fitted on the same datapoints, same seed."""
    dps = _ref_dps()
    return (predictor.Perf4Sight(n_estimators=24).fit(_port_dps(dps)),
            ref_predictor.Perf4Sight(n_estimators=24).fit(dps))


@pytest.fixture(scope="module")
def spec_pairs():
    """(port spec, reference spec) of 12 pruned squeezenets and resnet50s."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(12):
        family = "squeezenet" if i % 2 else "resnet50"
        m, r = _pair(family, float(rng.uniform(0, 0.8)), seed=i)
        out.append((m.conv_specs(), r.conv_specs()))
    return out


def _same(a, b):
    """Two estimates (port, reference) equal field by field."""
    assert (a.gamma_mb, a.phi_ms, a.energy_j, a.source) == \
           (b.gamma_mb, b.phi_ms, b.energy_j, b.source)
    assert a.detail == b.detail


# ---------------------------------------------------------------------------
# CostQuery and CostEstimate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["train", "infer"])
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("family", FAMILIES)
def test_spec_query_key_identical(family, level, stage):
    m, r = _pair(family, level)
    for bs in (1, 16):
        mine = CostQuery(spec=m.conv_specs(), bs=bs, stage=stage)
        ref = ref_types.CostQuery(spec=r.conv_specs(), bs=bs, stage=stage)
        assert mine.key == ref.key
        # model-only queries key on the conv geometry too, but the port's
        # marks them as model-only (a departure from the reference's key,
        # whose model-only key aliases the spec key of the same geometry)
        assert CostQuery(bs=bs, stage=stage, model=m).key != mine.key
        assert ref_types.CostQuery(bs=bs, stage=stage, model=r).key == ref.key


def test_full_width_resnet50_key_identical():
    m, r = _pair("resnet50", 0.0, wm=1.0, hw=32)
    assert CostQuery(spec=m.conv_specs(), bs=16).key == \
        ref_types.CostQuery(spec=r.conv_specs(), bs=16).key


@pytest.mark.parametrize("kw", [
    dict(arch="qwen3-4b"), dict(arch="qwen3-4b", reduced=True),
    dict(arch="qwen3-4b", reduced=False, seq=512),
    dict(arch="mamba2-780m", stage="infer", seq=128)])
def test_arch_query_key_identical(kw):
    assert CostQuery(bs=8, **kw).key == ref_types.CostQuery(bs=8, **kw).key


def test_key_of_a_model_without_conv_specs_identical():
    class Opaque:
        name = "opaque"
        widths = {"b": 2, "a": 1}

    assert CostQuery(bs=2, model=Opaque()).key == \
        ref_types.CostQuery(bs=2, model=Opaque()).key


def test_query_validation_as_reference():
    for kw in (dict(bs=8), dict(bs=8, arch="qwen3-4b", stage="decode")):
        with pytest.raises(ValueError):
            CostQuery(**kw)
        with pytest.raises(ValueError):
            ref_types.CostQuery(**kw)
    assert (CostQuery(bs=1, arch="a") == CostQuery(bs=1, arch="a", model=object()))


def test_estimate_dict_round_trip_across_packages():
    est = CostEstimate(gamma_mb=1.5, phi_ms=2.25, energy_j=0.5, source="forest",
                       detail={"k": [1, 2]})
    ref = ref_types.CostEstimate.from_dict(est.to_dict())
    assert ref.to_dict() == est.to_dict()
    old = {"gamma_mb": 1, "phi_ms": 2}          # a cache written before energy
    assert CostEstimate.from_dict(old).to_dict() == \
        ref_types.CostEstimate.from_dict(old).to_dict()


# ---------------------------------------------------------------------------
# EstimateCache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_estimate_cache_file_loads_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "estimates.json")
    W, R = ((EstimateCache, RefEstimateCache) if writer == "port"
            else (RefEstimateCache, EstimateCache))
    E = CostEstimate if writer == "port" else ref_types.CostEstimate
    c = W(path)
    for i in range(3):
        c.put(f"k{i}", E(gamma_mb=float(i), phi_ms=i / 3, energy_j=0.1 * i,
                         source="s", detail={"i": i}))
    c.flush()
    back = R(path)
    assert len(back) == 3 and "k1" in back and "nope" not in back
    for i in range(3):
        assert back.get(f"k{i}").to_dict() == c.get(f"k{i}").to_dict()
    with open(path) as f:
        on_disk = json.load(f)
    assert on_disk == json.loads(json.dumps(R(path)._data))


def test_estimate_cache_quarantines_corrupt_file_as_reference(tmp_path):
    for i, C in enumerate((EstimateCache, RefEstimateCache)):
        path = tmp_path / f"e{i}.json"
        path.write_text('{"truncated": ')
        assert len(C(str(path))) == 0
        assert (tmp_path / f"e{i}.json.corrupt").exists()


def test_estimate_cache_isolated_from_caller_annotations(tmp_path):
    path = str(tmp_path / "estimates.json")
    c = EstimateCache(path)
    est = CostEstimate(gamma_mb=1.0, phi_ms=1.0, detail={"a": {"b": 1}})
    c.put("k", est)
    est.detail["a"]["b"] = object()        # not JSON: must not reach the file
    c.flush()
    assert RefEstimateCache(path).get("k").detail == {"a": {"b": 1}}


# ---------------------------------------------------------------------------
# ForestBackend
# ---------------------------------------------------------------------------

def test_forest_backend_estimates_identical(predictors, spec_pairs):
    mine_p, ref_p = predictors
    mine = ForestBackend(train=mine_p, infer=mine_p)
    ref = ref_backends.ForestBackend(train=ref_p, infer=ref_p)
    assert mine.cache_salt() == ref.cache_salt()
    stages = ["train" if i % 3 else "infer" for i in range(len(spec_pairs))]
    got = mine.estimate([CostQuery(spec=m, bs=4 + i, stage=s)
                         for i, ((m, _), s) in enumerate(zip(spec_pairs, stages))])
    want = ref.estimate([ref_types.CostQuery(spec=r, bs=4 + i, stage=s)
                         for i, ((_, r), s) in enumerate(zip(spec_pairs, stages))])
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("ext", ["json", "npz"])
def test_forest_backend_on_a_reference_saved_forest(predictors, spec_pairs, tmp_path, ext):
    _, ref_p = predictors
    path = str(tmp_path / f"forest.{ext}")
    ref_p.save(path)
    loaded = predictor.Perf4Sight.load(path)
    mine = ForestBackend(train=loaded)
    ref = ref_backends.ForestBackend(train=ref_p)
    assert mine.cache_salt() == ref.cache_salt()
    got = mine.estimate([CostQuery(spec=m, bs=16) for m, _ in spec_pairs])
    want = ref.estimate([ref_types.CostQuery(spec=r, bs=16) for _, r in spec_pairs])
    for a, b in zip(got, want):
        _same(a, b)


def test_forest_backend_support_as_reference(predictors, spec_pairs):
    mine_p, ref_p = predictors
    (m, r), unfitted = spec_pairs[0], predictor.Perf4Sight()
    mine = ForestBackend(train=mine_p, infer=unfitted)
    ref = ref_backends.ForestBackend(train=ref_p, infer=ref_predictor.Perf4Sight())
    for stage in ("train", "infer"):
        assert mine.supports(CostQuery(spec=m, bs=2, stage=stage)) == \
            ref.supports(ref_types.CostQuery(spec=r, bs=2, stage=stage))
    assert not mine.supports(CostQuery(bs=2, arch="qwen3-4b"))
    assert mine.cache_salt() == ref.cache_salt()
    with pytest.raises(BackendUnavailable):
        mine.estimate([CostQuery(spec=m, bs=2, stage="infer")])
    assert ForestBackend().cache_salt() == ref_backends.ForestBackend().cache_salt()


class _FakeLMForest:
    """A fitted LM forest stand-in (the reference's tests' ``_FakeLMForest``
    with an optional energy model): constant (Γ, Φ[, E]) per query.  One
    per package: ``default_device`` is that package's ``host_cpu``."""

    fitted = True
    meta = {"plan_hash": "plan-7"}

    def __init__(self, get_device, gamma_mb, phi_ms=1.0, energy_j=None):
        self.gamma_mb, self.phi_ms, self.energy_j = gamma_mb, phi_ms, energy_j
        self.energy_fitted = energy_j is not None
        self.default_device = get_device("host_cpu")

    def content_hash(self):
        return f"fake-{self.gamma_mb}-{self.phi_ms}-{self.energy_j}"

    def predict_queries(self, queries):
        g = np.array([self.gamma_mb * q.bs for q in queries])
        return g, np.full(len(queries), self.phi_ms)

    def predict_energy(self, queries):
        return np.array([self.energy_j * q.seq for q in queries])


@pytest.mark.parametrize("energy_j", [None, 0.25])
def test_forest_backend_lm_branch_as_reference(predictors, spec_pairs, energy_j):
    mine_p, ref_p = predictors
    mine = ForestBackend(train=mine_p, lm=_FakeLMForest(devices.get_device, 40.0, 3.0, energy_j))
    ref = ref_backends.ForestBackend(train=ref_p,
                                     lm=_FakeLMForest(ref_devices.get_device, 40.0, 3.0, energy_j))
    assert mine.cache_salt() == ref.cache_salt()
    (m, r) = spec_pairs[0]
    qs = [dict(arch="qwen3-4b", bs=2, seq=128), dict(arch="internlm2-1.8b", bs=5, seq=64,
                                                     stage="train")]
    got = mine.estimate([CostQuery(spec=m, bs=4)] + [CostQuery(**q) for q in qs])
    want = ref.estimate([ref_types.CostQuery(spec=r, bs=4)]
                        + [ref_types.CostQuery(**q) for q in qs])
    assert [e.to_dict() for e in got] == [e.to_dict() for e in want]
    assert got[1].detail == {"lm": True, "device": "host_cpu", "plan_hash": "plan-7"}


def test_forest_backend_unfitted_lm_forest_as_reference():
    """``ForestBackend(lm=<not fitted>)`` answers no arch query and salts
    as if it had none, as the reference's does."""
    q = dict(arch="qwen3-4b", bs=2)
    mine, ref = ForestBackend(lm=object()), ref_backends.ForestBackend(lm=object())
    assert mine.cache_salt() == ref.cache_salt() == ForestBackend().cache_salt()
    assert not mine.supports(CostQuery(**q)) and not ref.supports(ref_types.CostQuery(**q))
    with pytest.raises(BackendUnavailable, match="forest backend cannot answer"):
        mine.estimate([CostQuery(**q)])


# ---------------------------------------------------------------------------
# AnalyticalBackend (CNN closed forms)
# ---------------------------------------------------------------------------

def _calibrated_pair():
    """One fitted spec per package with class-wise latency and energy
    constants (planted, not fitted here: tests/test_torch_calibrate.py
    holds the fit)."""
    coeffs = {"cnn_latency": {"_intercept": 1e-3, "flops_matmul": 2e-12,
                              "hbm_elementwise": 3e-11, "hbm_data_movement": 0.0},
              "cnn_energy": {"_intercept": 0.05, "flops_matmul": 1e-10,
                             "hbm_elementwise": 2e-9, "hbm_data_movement": 4e-10}}
    kw = dict(name="cal", peak_flops=3.1e11, hbm_bw=2.7e10, launch_overhead_s=2e-3,
              mem_base_mb=12.0, mem_weight_scale=3.5, mem_act_scale=1.25,
              alloc_granularity=512, combine="sum", calibrated=True,
              class_coeffs=coeffs, idle_w=20.0, peak_w=60.0)
    return devices.DeviceSpec(**kw), ref_devices.DeviceSpec(**kw)


def _device_pairs():
    cal = _calibrated_pair()
    no_classwise = tuple(dataclasses.replace(s, name="cal_agg", class_coeffs={})
                         for s in cal)
    return {"host_cpu": ("host_cpu", "host_cpu"), "tpu_v5e": ("tpu_v5e", "tpu_v5e"),
            "calibrated": cal, "calibrated_aggregate": no_classwise}


@pytest.mark.parametrize("device", list(_device_pairs()))
def test_analytical_backend_estimates_identical(spec_pairs, device):
    """Every estimate field and detail equal; the numbers at rel 1e-12
    (numpy in both packages; the tolerance only admits a last-bit
    difference, of which there is none today)."""
    mine_dev, ref_dev = _device_pairs()[device]
    mine, ref = AnalyticalBackend(device=mine_dev), ref_backends.AnalyticalBackend(device=ref_dev)
    assert mine.cache_salt() == ref.cache_salt()
    qs = [(CostQuery(spec=m, bs=bs, stage=st), ref_types.CostQuery(spec=r, bs=bs, stage=st))
          for (m, r) in spec_pairs[:6] for bs in (1, 8) for st in ("train", "infer")]
    got = mine.estimate([q for q, _ in qs])
    want = ref.estimate([q for _, q in qs])
    for a, b in zip(got, want):
        assert a.source == b.source == "analytical"
        np.testing.assert_allclose([a.gamma_mb, a.phi_ms, a.energy_j],
                                   [b.gamma_mb, b.phi_ms, b.energy_j], rtol=1e-12, atol=0)
        assert a.detail.keys() == b.detail.keys()
        for k in a.detail:
            if isinstance(b.detail[k], float):
                np.testing.assert_allclose(a.detail[k], b.detail[k], rtol=1e-12, atol=0)
            elif isinstance(b.detail[k], dict):
                assert a.detail[k].keys() == b.detail[k].keys()
                np.testing.assert_allclose(list(a.detail[k].values()),
                                           list(b.detail[k].values()), rtol=1e-12, atol=0)
            else:
                assert a.detail[k] == b.detail[k]
        assert np.isfinite([a.gamma_mb, a.phi_ms, a.energy_j]).all() and a.phi_ms > 0


def test_analytical_backend_salt_tracks_its_configuration():
    for kw in (dict(reduced=False), dict(bytes_per_el=2), dict(lm_device="host_cpu"),
               dict(device={"peak_flops_bf16": 1e12, "hbm_bw": 1e11})):
        assert AnalyticalBackend(**kw).cache_salt() == \
            ref_backends.AnalyticalBackend(**kw).cache_salt()
        assert AnalyticalBackend(**kw).cache_salt() != AnalyticalBackend().cache_salt()


def test_analytical_backend_falls_through_on_arch_and_model_only(spec_pairs):
    """An arch query the backend cannot trace (an unknown arch id) raises
    ``BackendUnavailable``, as a model-only query does, so an ensemble
    falls through to its next link."""
    backend = AnalyticalBackend()
    m = pruning.pruned_model("squeezenet", 0.3, "random", 0, width_mult=WM, input_hw=HW)
    assert backend.supports(CostQuery(bs=2, arch="no-such-arch"))
    with pytest.raises(BackendUnavailable, match="trace failed for no-such-arch"):
        backend.estimate([CostQuery(bs=2, arch="no-such-arch")])
    assert not backend.supports(CostQuery(bs=2, model=m))
    with pytest.raises(BackendUnavailable, match="model-only"):
        backend.estimate([CostQuery(bs=2, model=m)])
    assert backend.estimate([]) == []
    # an ensemble salvages the spec query of a mixed batch, the arch one
    # reaches the next link
    stub = _Stub("next", answer=7.0)
    ests = EnsembleBackend([backend, stub]).estimate(
        [CostQuery(spec=spec_pairs[0][0], bs=2), CostQuery(bs=2, arch="no-such-arch")])
    assert [e.source for e in ests] == ["analytical", "next"]
    assert backend.traces == 0


# ---------------------------------------------------------------------------
# AnalyticalBackend's LM branch: the step traced on meta tensors
# ---------------------------------------------------------------------------

LM_CASES = {"infer": ("qwen3-4b", 2, 64), "train": ("internlm2-1.8b", 2, 64)}


def _lm_spec_pair(fitted: bool):
    """The h100 spec in both packages, with class-wise LM constants when
    ``fitted`` (planted: the campaign fit is ROADMAP queue 1 item 6)."""
    kw = {}
    if fitted:
        kw["class_coeffs"] = {
            "lm_latency": {"_intercept": 2e-3, "flops_matmul": 1.5e-15,
                           "hbm_elementwise": 4e-13, "hbm_data_movement": 3e-13},
            "lm_energy": {"_intercept": 0.5, "flops_matmul": 8e-13,
                          "hbm_elementwise": 1e-10}}
    mine = dataclasses.replace(devices.get_device("h100"), **kw)
    return mine, ref_devices.DeviceSpec.from_dict(mine.to_dict())   # no h100 there


@pytest.fixture(autouse=False)
def _untuned(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


@pytest.mark.parametrize("fitted", [False, True], ids=["envelope", "fitted"])
@pytest.mark.parametrize("stage", ["infer", "train"])
def test_analytical_lm_estimate(_untuned, stage, fitted):
    """Reduced archs, each stage: finite fields, the reference's ``detail``
    keys, matmul FLOPs equal to the reference's HLO count (rel 1e-9),
    ``cost_classes`` re-summing to the aggregates (flops and bytes exactly,
    energy within 1e-9), Φ and energy from the envelope or from the fitted
    class-wise constants over the ledger's class columns, a repeated query
    answered from ``_compiled_cache`` with no trace, and the reference's
    cache salt.  Γ and bytes are the port's own (eager, meta-traced) and
    are printed beside the reference's."""
    arch, bs, seq = LM_CASES[stage]
    mine_dev, ref_dev = _lm_spec_pair(fitted)
    mine = AnalyticalBackend(lm_device=mine_dev)
    ref = ref_backends.AnalyticalBackend(lm_device=ref_dev)
    assert mine.cache_salt() == ref.cache_salt()
    q = CostQuery(arch=arch, bs=bs, seq=seq, stage=stage)
    est = mine.estimate([q])[0]
    want = ref.estimate([ref_types.CostQuery(arch=arch, bs=bs, seq=seq, stage=stage)])[0]
    print(f"{arch} {stage}: Γ {est.gamma_mb:.3f} / {want.gamma_mb:.3f} MB, Φ "
          f"{est.phi_ms:.5f} / {want.phi_ms:.5f} ms, bytes {est.detail['hbm_bytes']:.4e} / "
          f"{want.detail['hbm_bytes']:.4e} (port / reference)")
    d = est.detail
    assert est.source == "analytical" and d.keys() == want.detail.keys()
    assert np.isfinite([est.gamma_mb, est.phi_ms, est.energy_j]).all()
    assert est.gamma_mb > 0 and est.phi_ms > 0 and est.energy_j > 0
    assert d["flops"] == pytest.approx(want.detail["flops"], rel=1e-9)
    assert d["collective_bytes"] == want.detail["collective_bytes"] == 0.0
    assert (d["device"], d["reduced"], d["latency_fit"], d["energy_fit"]) == \
        (want.detail["device"], True, want.detail["latency_fit"], want.detail["energy_fit"])
    classes = d["cost_classes"]
    assert sum(c["flops"] for c in classes.values()) == d["flops"]
    assert sum(c["hbm_bytes"] for c in classes.values()) == d["hbm_bytes"]
    assert d["energy_classes"] == {k: c["energy_j"] for k, c in classes.items()}
    dyn = sum(d["energy_classes"].values())
    cols = decompose.ledger_latency_columns([classes])
    if fitted:
        assert d["latency_fit"] == "classwise" and d["energy_fit"] == "fitted"
        lat, en = mine_dev.class_coeffs["lm_latency"], mine_dev.class_coeffs["lm_energy"]
        assert est.phi_ms == float(ref_decompose.classwise_seconds(cols, lat)[0]) * 1e3
        assert est.energy_j == float(ref_decompose.classwise_seconds(cols, en)[0])
    else:
        compute_s, memory_s, coll_s = ref_decompose.lm_roofline_terms(
            d["flops"], d["hbm_bytes"], 0.0, ref_dev)
        assert est.phi_ms == ref_dev.combine_terms(compute_s, memory_s, coll_s) * 1e3
        assert est.energy_j == pytest.approx(d["energy_static_j"] + dyn, rel=1e-12)
        assert dyn == pytest.approx(ref_dev.dynamic_w * (compute_s + memory_s), rel=1e-9)
    assert d["dominant"] in ("compute", "memory") and d["compile_s"] > 0
    assert mine.traces == 1 and mine.last_trace[0] == q
    assert mine.estimate([q])[0] is est and mine.traces == 1


def test_analytical_lm_estimate_refuses_an_unknown_arch_and_keys_per_device(_untuned):
    mine = AnalyticalBackend(lm_device="h100")
    with pytest.raises(BackendUnavailable):
        mine.estimate([CostQuery(arch="no-such-arch", bs=1, stage="infer")])
    q = CostQuery(arch="qwen3-4b", bs=1, seq=32, stage="infer")
    a = mine.estimate([q])[0]
    mine.lm_device = devices.get_device("tpu_v5e")
    b = mine.estimate([q])[0]
    assert mine.traces == 2 and a.detail["device"] == "h100" and b.detail["device"] == "tpu_v5e"
    assert a.gamma_mb == b.gamma_mb and a.phi_ms != b.phi_ms
    full = mine.estimate([CostQuery(arch="qwen3-4b", bs=1, seq=32, stage="infer",
                                    reduced=True)])[0]
    assert full is b and mine.traces == 2     # reduced=None → the backend's default
    mine_dev, ref_dev = _lm_spec_pair(False)
    for reduced in (True, False):
        assert AnalyticalBackend(lm_device=mine_dev, reduced=reduced).cache_salt() == \
            ref_backends.AnalyticalBackend(lm_device=ref_dev, reduced=reduced).cache_salt()


def test_price_ledger_energy_bit_for_bit_across_packages(tmp_path, _untuned):
    """A traced ledger carried across as JSON, priced by each package under
    the same specs: every record's energy and the total are equal."""
    from repro.costmodel import CostLedger as RefLedger
    from repro_torch.configs.registry import get_config
    from repro_torch.core.hlo_cost import trace_cost
    from repro_torch.models import transformer as T

    cfg = get_config("qwen3-4b", reduced=True)
    spec = T.input_specs(cfg, "prefill", batch_size=2, seq_len=32)
    ledger = trace_cost(T.prefill, T.param_specs(cfg), spec["batch"], cfg,
                        max_len=32).ledger
    path = str(tmp_path / "ledger.json")
    ledger.save(path)
    ref_ledger = RefLedger.load(path)
    cal = _calibrated_pair()
    pairs = [(devices.get_device(n), ref_devices.get_device(n))
             for n in ("tpu_v5e", "tx2_like", "host_cpu")]
    for mine_dev, ref_dev in pairs + [_lm_spec_pair(False), cal]:
        a = decompose.price_ledger_energy(ledger, mine_dev)
        b = ref_decompose.price_ledger_energy(ref_ledger, ref_dev)
        assert [r.energy_j for r in a] == [r.energy_j for r in b]
        assert a.energy_j == b.energy_j and a.class_sums() == b.class_sums()
        assert [r.to_dict() for r in a] == [r.to_dict() for r in b]
    cols = decompose.ledger_latency_columns([ledger, None])
    want = ref_decompose.ledger_latency_columns([ref_ledger, None])
    assert cols.keys() == want.keys()
    for k in cols:
        np.testing.assert_array_equal(cols[k], want[k])


# ---------------------------------------------------------------------------
# EnsembleBackend, with tests/test_engine.py's stubs in both packages
# ---------------------------------------------------------------------------

def _stub_classes(types):
    class Stub:
        def __init__(self, name, answer=None, supported=True, fail=False):
            self.name, self.answer = name, answer
            self.supported, self.fail, self.calls = supported, fail, 0

        def supports(self, q):
            return self.supported

        def estimate(self, queries):
            self.calls += 1
            if self.fail:
                raise types.BackendUnavailable(f"{self.name} down")
            return [types.CostEstimate(gamma_mb=self.answer, phi_ms=self.answer,
                                       source=self.name) for _ in queries]

    class Partial:
        name = "partial"

        def __init__(self, poisoned):
            self.poisoned, self.calls = poisoned, 0

        def supports(self, q):
            return True

        def estimate(self, queries):
            self.calls += 1
            if any(q.bs in self.poisoned for q in queries):
                raise types.BackendUnavailable("poisoned query in batch")
            return [types.CostEstimate(gamma_mb=1.0, phi_ms=1.0, source=self.name)
                    for _ in queries]

    return Stub, Partial


_Stub, _Partial = _stub_classes(port_types)
_RefStub, _RefPartial = _stub_classes(ref_types)


def _chains(spec_pairs):
    """(name, chain factory(Stub, Partial), batch sizes): the reference
    test's cases, plus a chain that salvages and a chain that runs out."""
    return [
        ("first_wins", lambda S, P: [S("a", 1.0), S("b", 2.0)], (4,)),
        ("falls_through", lambda S, P: [S("skipme", supported=False),
                                        S("failing", fail=True), S("answering", 3.0)],
         (4, 4, 4)),
        ("salvage", lambda S, P: [P({13}), S("fallback", 9.0)], (2, 13, 4)),
        ("salvage_none", lambda S, P: [P({2, 13}), S("fallback", 9.0)], (2, 13)),
        ("exhausted", lambda S, P: [S("x", supported=False)], (4,)),
        ("all_down", lambda S, P: [S("down", fail=True), P({5})], (5, 6)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_ensemble_fall_through_and_salvage_as_reference(spec_pairs, case):
    name, make, bss = _chains(spec_pairs)[case]
    m, r = spec_pairs[0]
    chain, ref_chain = make(_Stub, _Partial), make(_RefStub, _RefPartial)
    ens, ref_ens = EnsembleBackend(chain), ref_backends.EnsembleBackend(ref_chain)

    def run(e, T, spec):
        try:
            return [x.to_dict() for x in e.estimate([T.CostQuery(spec=spec, bs=b) for b in bss])]
        except T.BackendUnavailable as exc:
            return f"BackendUnavailable: {exc}"

    got = run(ens, port_types, m)
    want = run(ref_ens, ref_types, r)
    assert got == want, name
    assert [b.calls for b in chain] == [b.calls for b in ref_chain]
    assert ens.supports(CostQuery(spec=m, bs=1)) == \
        ref_ens.supports(ref_types.CostQuery(spec=r, bs=1))
    assert ens.cache_salt() == ref_ens.cache_salt()


def test_ensemble_chain_forest_analytical(predictors, spec_pairs):
    mine_p, ref_p = predictors
    ens = EnsembleBackend([ForestBackend(train=mine_p), AnalyticalBackend()])
    ref = ref_backends.EnsembleBackend([ref_backends.ForestBackend(train=ref_p),
                                        ref_backends.AnalyticalBackend()])
    assert ens.cache_salt() == ref.cache_salt()
    (m, r) = spec_pairs[3]
    got = ens.estimate([CostQuery(spec=m, bs=4, stage=s) for s in ("train", "infer")])
    want = ref.estimate([ref_types.CostQuery(spec=r, bs=4, stage=s)
                         for s in ("train", "infer")])
    assert [e.source for e in got] == ["forest", "analytical"]
    for a, b in zip(got, want):
        _same(a, b)
    with pytest.raises(ValueError):
        EnsembleBackend([])


# ---------------------------------------------------------------------------
# HealthState and CostEngine
# ---------------------------------------------------------------------------

def test_health_state_metrics_over_one_sequence():
    rng = np.random.default_rng(3)
    mine = HealthState(["forest", "analytical", "static"], fail_threshold=2, probe_every=3)
    ref = ref_engine.HealthState(["forest", "analytical", "static"], fail_threshold=2,
                                 probe_every=3)
    for step in range(200):
        op, level = rng.integers(4), int(rng.integers(3))
        for h in (mine, ref):
            if op == 0:
                h.record_failure(ValueError(f"boom {step}"))
            elif op == 1:
                h.record_failure(f"text {step}" if step % 2 else None)
            elif op == 2:
                h.record_success(h.probe_level())
            else:
                h.record_success(level if step % 3 else None)
        assert mine.metrics() == ref.metrics()
        assert (mine.calls, mine.current, mine.degraded) == (ref.calls, ref.current,
                                                             ref.degraded)
    assert mine.failovers > 0 and mine.recoveries > 0 and mine.probes > 0
    with pytest.raises(ValueError):
        HealthState([])


def _engine_run(T, backend, path, spec, flush_every):
    """One scripted sequence through an engine; returns what it observed."""
    engine_cls = CostEngine if T is not ref_types else ref_engine.CostEngine
    cache_cls = EstimateCache if T is not ref_types else RefEstimateCache
    eng = engine_cls(backend, cache=cache_cls(path), flush_every=flush_every)
    seen = []
    qs = [T.CostQuery(spec=spec, bs=b) for b in (2, 4, 8)]
    for batch in (qs, qs[:2], qs + [T.CostQuery(spec=spec, bs=16)], qs):
        ests = eng.estimate(batch)
        seen.append(([e.to_dict() for e in ests], eng.hits, eng.misses, eng._pending,
                     sorted(json.load(open(path))) if os.path.exists(path)
                     else None))
    eng.flush()
    ok, info = eng.admit(qs[0], gamma_budget_mb=1.0, phi_budget_ms=10.0,
                         energy_budget_j=1.0)
    seen.append((ok, info, eng.hits, eng.misses))
    return seen


@pytest.mark.parametrize("flush_every", [1, 3, 100])
def test_engine_hits_misses_salts_and_flushes_identical(predictors, spec_pairs, tmp_path,
                                                        flush_every):
    mine_p, ref_p = predictors
    m, r = spec_pairs[1]
    got = _engine_run(port_types,
                      EnsembleBackend([ForestBackend(train=mine_p), AnalyticalBackend()]),
                      str(tmp_path / "mine.json"), m, flush_every)
    want = _engine_run(ref_types, ref_backends.EnsembleBackend(
        [ref_backends.ForestBackend(train=ref_p), ref_backends.AnalyticalBackend()]),
        str(tmp_path / "ref.json"), r, flush_every)
    assert got == want
    # the salted keys on disk are the same, so either file serves the other
    with open(tmp_path / "mine.json") as f, open(tmp_path / "ref.json") as g:
        assert json.load(f) == json.load(g)


def test_engine_serves_a_reference_written_cache(predictors, spec_pairs, tmp_path):
    mine_p, ref_p = predictors
    path = str(tmp_path / "estimates.json")
    (m, r) = spec_pairs[2]
    ref_eng = ref_engine.CostEngine(ref_backends.ForestBackend(train=ref_p), cache=path)
    want = ref_eng.estimate([ref_types.CostQuery(spec=r, bs=b) for b in (2, 4)])
    eng = CostEngine(ForestBackend(train=mine_p), cache=path)
    got = eng.estimate([CostQuery(spec=m, bs=b) for b in (2, 4)])
    assert (eng.hits, eng.misses) == (2, 0)
    assert [g.detail for g in got] == [{"cached": True}] * 2
    assert [(g.gamma_mb, g.phi_ms) for g in got] == [(w.gamma_mb, w.phi_ms) for w in want]
    # a refit predictor changes the salt: a miss, not a stale hit
    mine_p2 = predictor.Perf4Sight(n_estimators=6).fit(_port_dps(_ref_dps(20, seed=5)))
    eng2 = CostEngine(ForestBackend(train=mine_p2), cache=path)
    eng2.estimate([CostQuery(spec=m, bs=2)])
    assert (eng2.hits, eng2.misses) == (0, 1)


@pytest.mark.parametrize("device", [None, "host_cpu", "tpu_v5e"])
def test_engine_device_salt_and_admission_capacity(spec_pairs, tmp_path, device):
    m, r = spec_pairs[0]
    got = CostEngine(_Stub("s", 3.0), cache=str(tmp_path / "a.json"), device=device)
    want = ref_engine.CostEngine(_RefStub("s", 3.0), cache=str(tmp_path / "b.json"),
                                 device=device)
    assert got._salt() == want._salt()
    assert got.admit(CostQuery(spec=m, bs=2)) == want.admit(ref_types.CostQuery(spec=r, bs=2))
    assert got.estimate_requests("qwen3-4b", [1, 63, 64, 65, 300], bucket=64)[0].to_dict() \
        == want.estimate_requests("qwen3-4b", [1, 63, 64, 65, 300], bucket=64)[0].to_dict()
    assert (got.hits, got.misses) == (want.hits, want.misses)
    with open(tmp_path / "a.json") as f, open(tmp_path / "b.json") as g:
        assert sorted(json.load(f)) == sorted(json.load(g))


def test_engine_without_cache(spec_pairs):
    m, _ = spec_pairs[0]
    stub = _Stub("s", 1.0)
    eng = CostEngine(stub)
    eng.estimate([CostQuery(spec=m, bs=2)] * 2)
    eng.estimate([CostQuery(spec=m, bs=2)])
    assert (eng.hits, eng.misses, stub.calls) == (0, 3, 2)
    eng.flush()


def test_model_only_query_after_a_spec_query_reaches_the_profiler(predictors, tmp_path):
    """A model-only query asks for a measurement: after the spec query of
    the same geometry (answered by the forest and cached), it misses the
    cache and falls through to the profiler; its repeat is a hit."""
    mine_p, _ = predictors
    m = pruning.pruned_model("resnet50", 0.5, "random", width_mult=0.125, input_hw=16)
    eng = CostEngine(EnsembleBackend([ForestBackend(train=mine_p),
                                      ProfilerBackend(repeats=1, warmup=0, device="cpu")]),
                     cache=str(tmp_path / "estimates.json"))
    spec_est, = eng.estimate([CostQuery(spec=m.conv_specs(), bs=2)])
    measured, = eng.estimate([CostQuery(bs=2, model=m)])
    assert (spec_est.source, measured.source) == ("forest", "profiler")
    assert (eng.hits, eng.misses) == (0, 2)
    again, = eng.estimate([CostQuery(bs=2, model=m)])
    assert (eng.hits, eng.misses) == (1, 2)
    assert again.source == "profiler" and again.detail["cached"] is True
    assert (again.gamma_mb, again.phi_ms) == (measured.gamma_mb, measured.phi_ms)


# ---------------------------------------------------------------------------
# decompose
# ---------------------------------------------------------------------------

def _feature_rows():
    rng = np.random.default_rng(11)
    specs = [pruning.pruned_model(f, float(rng.uniform(0, 0.8)), "random", i,
                                  width_mult=WM, input_hw=HW).conv_specs()
             for i, f in enumerate(FAMILIES * 2)]
    return features.feature_matrix([(s, int(b)) for s, b in
                                    zip(specs, rng.integers(1, 64, len(specs)))])


@pytest.mark.parametrize("device", ["host_cpu", "tpu_v5e", "tx2_like", "h100"])
def test_decompose_terms_identical(device):
    F = _feature_rows()
    dev = devices.get_device(device)
    # h100 is the port's own registry entry: the reference prices its copy
    ref_dev = (ref_devices.get_device(device) if device in ref_devices.DEVICE_REGISTRY
               else ref_devices.DeviceSpec.from_dict(dev.to_dict()))
    for bpe in (2, 4):
        for a, b in zip(decompose.latency_terms(F, bpe), ref_decompose.latency_terms(F, bpe)):
            assert np.array_equal(a, b)
        for a, b in zip(decompose.memory_terms(F, bpe), ref_decompose.memory_terms(F, bpe)):
            assert np.array_equal(a, b)
        mine = decompose.latency_class_columns(F, bpe)
        ref = ref_decompose.latency_class_columns(F, bpe)
        assert list(mine) == list(ref) == list(decompose.CNN_LATENCY_COLUMNS)
        assert all(np.array_equal(mine[k], ref[k]) for k in mine)
        mine = decompose.cnn_energy_class_joules(F, bpe, dev)
        ref = ref_decompose.cnn_energy_class_joules(F, bpe, ref_dev)
        assert all(np.array_equal(mine[k], ref[k]) for k in ref) and mine.keys() == ref.keys()
    flops, nbytes = decompose.latency_terms(F, 4)
    phi = np.linspace(1e-3, 1.0, len(flops))
    for a, b in zip(decompose.energy_terms(flops, nbytes, phi, dev, 1e6),
                    ref_decompose.energy_terms(flops, nbytes, phi, ref_dev, 1e6)):
        assert np.array_equal(a, b)
    for a, b in zip(decompose.lm_roofline_terms(flops, nbytes, 3e5, dev),
                    ref_decompose.lm_roofline_terms(flops, nbytes, 3e5, ref_dev)):
        assert np.array_equal(a, b)
    assert np.array_equal(decompose.watts_proxy(flops, np.r_[0.0, phi[1:]], dev),
                          ref_decompose.watts_proxy(flops, np.r_[0.0, phi[1:]], ref_dev))
    assert np.array_equal(decompose.collective_seconds(nbytes, dev),
                          ref_decompose.collective_seconds(nbytes, ref_dev))


def test_classwise_and_ledger_columns_identical():
    rng = np.random.default_rng(2)
    assert decompose.LM_LATENCY_COLUMNS == ref_decompose.LM_LATENCY_COLUMNS
    rows = [{cls: {"flops": float(rng.uniform(0, 1e9)), "hbm_bytes": float(rng.uniform(0, 1e8)),
                   "collective_bytes": float(rng.uniform(0, 1e6))}
             for cls in decompose.OP_CLASSES if rng.random() < 0.7} for _ in range(5)]
    rows.append(None)
    mine = decompose.ledger_latency_columns(rows)
    ref = ref_decompose.ledger_latency_columns(rows)
    assert mine.keys() == ref.keys() and all(np.array_equal(mine[k], ref[k]) for k in mine)
    coeffs = {"_intercept": 1e-3, "flops_matmul": 1e-12, "hbm_elementwise": 0.0,
              "collective": 2e-9}
    assert np.array_equal(decompose.classwise_seconds(mine, coeffs),
                          ref_decompose.classwise_seconds(ref, coeffs))
    fitted = dataclasses.replace(devices.get_device("tpu_v5e"),
                                 class_coeffs={"lm_latency": {"collective": 3e-10}})
    ref_fitted = ref_devices.DeviceSpec.from_dict(fitted.to_dict())
    assert np.array_equal(decompose.collective_seconds(mine["collective"], fitted),
                          ref_decompose.collective_seconds(ref["collective"], ref_fitted))


# ---------------------------------------------------------------------------
# ProfilerBackend: a measurement, held by definition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["train", "infer"])
def test_profiler_backend_on_cpu(stage):
    m = pruning.pruned_model("squeezenet", 0.5, "uniform", width_mult=0.125, input_hw=16)
    backend = ProfilerBackend(repeats=1, warmup=0, device="cpu")
    q = CostQuery(spec=m.conv_specs(), bs=2, stage=stage, model=m)
    assert backend.supports(q) and not backend.supports(CostQuery(spec=m.conv_specs(), bs=2))
    est = backend.estimate([q])[0]
    ref_keys = ("compile_s", "flops", "temp_mb")    # ref_backends.ProfilerBackend.estimate
    assert est.source == "profiler" and tuple(est.detail) == ref_keys
    assert np.isfinite([est.gamma_mb, est.phi_ms, est.detail["compile_s"],
                        est.detail["temp_mb"]]).all()
    assert est.gamma_mb > 0 and est.phi_ms > 0 and est.detail["flops"] > 0
    with pytest.raises(BackendUnavailable):
        backend.estimate([CostQuery(spec=m.conv_specs(), bs=2)])
    assert backend.cache_salt() == "profiler:1:0:True:cpu"
