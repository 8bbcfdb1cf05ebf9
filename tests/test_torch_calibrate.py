"""The port's calibration against the reference's: workload keys, the
ground truth served from the read-only fixture, the fitted ``DeviceSpec``
(field by field, and its fingerprint), the NNLS solver, the timed tuning
rows, ``evaluate_accuracy`` and the calibrated analytical estimates.

Calibration is numpy over the same datapoints in both packages, so every
fitted constant is held exactly (``==``).  A cold-cache calibration
profiles on the CPU through ``ProfilerBackend(device="cpu")`` and is held
by definition (its datapoints are measurements).
"""

import dataclasses
import importlib
from pathlib import Path

import numpy as np
import pytest

from repro.core.dataset import DatasetCache as RefDatasetCache
from repro.engine import backends as ref_backends
from repro.engine import devices as ref_devices
from repro.engine import types as ref_types
from repro.kernels import autotune as ref_at
from repro.kernels.conv_mm import tiling as ref_conv
from repro.kernels.flash_attention import tiling as ref_flash
from repro_torch.core.dataset import Datapoint, DatasetCache
from repro_torch.engine import (
    AnalyticalBackend,
    CostEngine,
    CostQuery,
    EstimateCache,
    ProfilerBackend,
    calibrate,
    default_workloads,
    evaluate_accuracy,
    load_device_spec,
    measure_ground_truth,
    save_device_spec,
    timed_tuning_rows,
)
from repro_torch.engine.calibrate import CalibrationWorkload, nnls
from repro_torch.kernels.autotune import TuningCache
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

# the module: ``repro.engine.calibrate`` as an attribute is the function
ref_cal = importlib.import_module("repro.engine.calibrate")

FIXTURE = str(Path(__file__).resolve().parents[1] / "benchmarks" / "cache" / "cnn_profile.json")
# tests/test_calibration.py's grid: every cell is in the fixture
GRID = dict(families=("squeezenet",), levels=(0.0, 0.30, 0.50), batch_sizes=(2, 8, 16, 32))
WORKLOADS = default_workloads(**GRID)
REF_WORKLOADS = ref_cal.default_workloads(**GRID)


def _profiler():
    return ProfilerBackend(repeats=1, warmup=0, device="cpu")


def _ref_profiler():
    return ref_backends.ProfilerBackend(repeats=1, warmup=0)


@pytest.fixture(scope="module")
def ground_truth():
    """(port, reference) datapoints of the grid, both from the fixture."""
    mine, n = measure_ground_truth(_profiler(), WORKLOADS, DatasetCache(FIXTURE))
    ref, n_ref = ref_cal.measure_ground_truth(_ref_profiler(), REF_WORKLOADS,
                                              RefDatasetCache(FIXTURE))
    assert n == n_ref == 0, "the grid must come from the fixture alone"
    return mine, ref


def _fields(spec):
    return dataclasses.asdict(spec)


@pytest.fixture(scope="module")
def tuning_path(tmp_path_factory):
    """A tuning cache with timed winners of two kernels, written by the
    reference's ``TuningCache`` (the file format both packages read)."""
    path = str(tmp_path_factory.mktemp("tuning") / "kernel_tuning.json")
    cache = ref_at.TuningCache(path)
    shapes = [("conv_mm", ref_conv.shape_key((2, 16, 16, 32), (3, 3, 32, 64), stride=1,
                                             padding=1, dtype="float32"), 41.0),
              ("conv_mm", ref_conv.shape_key((8, 32, 32, 128), (3, 3, 128, 128), stride=1,
                                             padding=1, dtype="float32"), 310.0),
              ("flash_attention", ref_flash.shape_key((1, 4, 512, 64), (1, 2, 512, 64),
                                                      causal=True, dtype="bfloat16"), 95.5)]
    for i, (kernel, shape, us) in enumerate(shapes):
        cfg = ref_at.get_tiling(kernel).default(shape)
        cache.put(f"timed{i}", {"kernel": kernel, "config": cfg, "shape": shape,
                                "source": "timed", "measured_us": us})
    # entries the rows must skip: model-ranked, shapeless, unknown kernel
    cache.put("model", {"kernel": "conv_mm", "config": cfg, "shape": shape,
                        "source": "model", "measured_us": None})
    cache.put("old", {"kernel": "conv_mm", "config": cfg, "source": "timed",
                      "measured_us": 5.0})
    cache.put("gone", {"kernel": "retired", "config": {}, "shape": {"N": 1},
                       "source": "timed", "measured_us": 5.0})
    cache.flush()
    return path


# ---------------------------------------------------------------------------
# workloads and ground truth
# ---------------------------------------------------------------------------

def test_workloads_and_keys_identical():
    assert [dataclasses.astuple(w) for w in WORKLOADS] == \
        [dataclasses.astuple(w) for w in REF_WORKLOADS]
    assert [w.key for w in WORKLOADS] == [w.key for w in REF_WORKLOADS]
    kw = dict(families=("resnet50", "squeezenet"), levels=(0.1,), batch_sizes=(4,),
              width_mult=1.0, input_hw=32, strategy="l1", seed=3)
    assert [w.key for w in default_workloads(**kw)] == \
        [w.key for w in ref_cal.default_workloads(**kw)]
    for w in WORKLOADS:
        dp = Datapoint(family=w.family, level=w.level, strategy=w.strategy, bs=w.bs,
                       width_mult=w.width_mult, input_hw=w.input_hw, seed=w.seed,
                       gamma_mb=0.0, phi_ms=0.0)
        assert w.key == dp.key
        assert w.key in DatasetCache(FIXTURE)._data


def test_workload_builds_the_reference_topology():
    for w, r in zip(WORKLOADS[::4], REF_WORKLOADS[::4]):
        m, rm = w.build_model(), r.build_model()
        assert (m.name, m.widths) == (rm.name, rm.widths)
        assert CostQuery(spec=m.conv_specs(), bs=w.bs).key == \
            ref_types.CostQuery(spec=rm.conv_specs(), bs=r.bs).key


def test_ground_truth_identical(ground_truth):
    mine, ref = ground_truth
    assert [dataclasses.asdict(a) for a in mine] == [dataclasses.asdict(b) for b in ref]


def test_ground_truth_fills_missing_features_as_reference(tmp_path):
    """A cached datapoint without features gets them from its topology."""
    import json

    with open(FIXTURE) as f:
        data = json.load(f)
    keys = [w.key for w in WORKLOADS[:3]]
    path = tmp_path / "no_features.json"
    path.write_text(json.dumps({k: {**data[k], "features": []} for k in keys}))
    mine, n = measure_ground_truth(_profiler(), WORKLOADS[:3], DatasetCache(str(path)))
    ref, n_ref = ref_cal.measure_ground_truth(_ref_profiler(), REF_WORKLOADS[:3],
                                              RefDatasetCache(str(path)))
    assert n == n_ref == 0
    assert [dp.features for dp in mine] == [dp.features for dp in ref]
    assert all(len(dp.features) == 42 for dp in mine)


def test_cold_cache_profiles_on_the_cpu(tmp_path):
    """A workload missing from the cache is profiled once (one training
    step on the CPU) and written back; a second pass profiles nothing."""
    path = str(tmp_path / "cold.json")
    tiny = [CalibrationWorkload("squeezenet", lv, bs=2, width_mult=0.125)
            for lv in (0.0, 0.5)]
    dps, n = measure_ground_truth(_profiler(), tiny, DatasetCache(path))
    assert n == 2 and len(DatasetCache(path)) == 2
    for dp, w in zip(dps, tiny):
        assert dp.key == w.key and len(dp.features) == 42
        assert np.isfinite([dp.gamma_mb, dp.phi_ms]).all() and dp.gamma_mb > 0 and dp.phi_ms > 0
    again, n = measure_ground_truth(_profiler(), tiny, DatasetCache(path))
    assert n == 0 and [dataclasses.asdict(d) for d in again] == \
        [dataclasses.asdict(d) for d in dps]


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base", ["host_cpu", "tpu_v5e", "tx2_like"])
def test_calibrate_fits_the_reference_spec(ground_truth, base):
    backend = AnalyticalBackend(device=base)
    ref_backend = ref_backends.AnalyticalBackend(device=base)
    spec = calibrate(backend, _profiler(), WORKLOADS, cache=FIXTURE)
    ref = ref_cal.calibrate(ref_backend, _ref_profiler(), REF_WORKLOADS, cache=FIXTURE)
    assert _fields(spec) == _fields(ref)
    assert spec.fingerprint() == ref.fingerprint()
    assert backend.device is spec and backend.cache_salt() == ref_backend.cache_salt()
    assert spec.calibrated and spec.combine == "sum" and spec.meta["n_profiled"] == 0
    consts = [spec.peak_flops, spec.hbm_bw, spec.launch_overhead_s, spec.mem_base_mb,
              spec.mem_weight_scale, spec.mem_act_scale]
    assert np.isfinite(consts).all() and min(consts) >= 0


def test_calibrate_on_premeasured_datapoints_and_names(ground_truth):
    mine, ref = ground_truth
    spec = calibrate(AnalyticalBackend(), _profiler(), WORKLOADS, datapoints=list(mine),
                     name="fit", apply=False)
    ref_spec = ref_cal.calibrate(ref_backends.AnalyticalBackend(), _ref_profiler(),
                                 REF_WORKLOADS, datapoints=list(ref), name="fit", apply=False)
    assert _fields(spec) == _fields(ref_spec) and spec.name == "fit"
    via_cache = calibrate(AnalyticalBackend(), _profiler(), WORKLOADS, cache=FIXTURE,
                          name="fit")
    assert via_cache.fingerprint() == spec.fingerprint()
    with pytest.raises(ValueError, match="3 workloads"):
        calibrate(AnalyticalBackend(), _profiler(), WORKLOADS[:2], cache=FIXTURE)


def test_timed_tuning_rows_identical(tuning_path):
    A, phi = timed_tuning_rows(TuningCache(tuning_path))
    ref_A, ref_phi = ref_cal.timed_tuning_rows(ref_at.TuningCache(tuning_path))
    assert A.shape == (3, 3) and np.array_equal(A, ref_A) and np.array_equal(phi, ref_phi)
    empty = TuningCache(str(Path(tuning_path).with_name("empty.json")))
    A, phi = timed_tuning_rows(empty)
    assert A.shape == (0, 3) and phi.shape == (0,)


def test_calibrate_with_timed_tuning_rows_identical(ground_truth, tuning_path):
    spec = calibrate(AnalyticalBackend(), _profiler(), WORKLOADS, cache=FIXTURE,
                     tuning_cache=TuningCache(tuning_path))
    ref = ref_cal.calibrate(ref_backends.AnalyticalBackend(), _ref_profiler(),
                            REF_WORKLOADS, cache=FIXTURE,
                            tuning_cache=ref_at.TuningCache(tuning_path))
    assert spec.meta["n_timed_kernel_rows"] == 3
    assert _fields(spec) == _fields(ref) and spec.fingerprint() == ref.fingerprint()


def test_calibrate_energy_from_measured_joules_identical(ground_truth):
    """Datapoints with a sampled power rail are fitted on their joules,
    the rest on the watts proxy."""
    mine, ref = ground_truth
    joules = np.random.default_rng(4).uniform(0.1, 2.0, len(mine))
    mine = [dataclasses.replace(dp, energy_j=float(j) if i % 2 else 0.0)
            for i, (dp, j) in enumerate(zip(mine, joules))]
    ref = [dataclasses.replace(dp, energy_j=float(j) if i % 2 else 0.0)
           for i, (dp, j) in enumerate(zip(ref, joules))]
    for base in ("tpu_v5e", "host_cpu"):        # a powered and a zero-watt envelope
        spec = calibrate(AnalyticalBackend(device=base), _profiler(), WORKLOADS,
                         datapoints=mine)
        ref_spec = ref_cal.calibrate(ref_backends.AnalyticalBackend(device=base),
                                     _ref_profiler(), REF_WORKLOADS, datapoints=ref)
        assert _fields(spec) == _fields(ref_spec)
        assert spec.meta["energy_fit"] != "none"


def test_evaluate_accuracy_identical(ground_truth):
    mine, ref = ground_truth
    backend, ref_backend = AnalyticalBackend(), ref_backends.AnalyticalBackend()
    before = evaluate_accuracy(backend, mine)
    assert before == ref_cal.evaluate_accuracy(ref_backend, ref)
    calibrate(backend, _profiler(), WORKLOADS, datapoints=mine)
    ref_cal.calibrate(ref_backend, _ref_profiler(), REF_WORKLOADS, datapoints=ref)
    after = evaluate_accuracy(backend, mine)
    assert after == ref_cal.evaluate_accuracy(ref_backend, ref)
    assert after["n"] == len(WORKLOADS) and after["phi_mape"] < before["phi_mape"]


def test_calibrated_estimates_identical_and_never_alias(ground_truth, tmp_path):
    """Calibrated train and infer estimates equal the reference's; the
    engine's salt moves with the spec, so the calibrated query misses."""
    mine, ref = ground_truth
    backend, ref_backend = AnalyticalBackend(), ref_backends.AnalyticalBackend()
    spec = WORKLOADS[5].build_model().conv_specs()
    ref_spec = REF_WORKLOADS[5].build_model().conv_specs()
    path = str(tmp_path / "estimates.json")
    e1 = CostEngine(backend, cache=EstimateCache(path))
    uncal = e1.estimate_one(CostQuery(spec=spec, bs=8))
    calibrate(backend, _profiler(), WORKLOADS, datapoints=mine)
    ref_cal.calibrate(ref_backend, _ref_profiler(), REF_WORKLOADS, datapoints=ref)
    e2 = CostEngine(backend, cache=EstimateCache(path))
    qs = [CostQuery(spec=spec, bs=bs, stage=st) for bs in (1, 8) for st in ("train", "infer")]
    got = e2.estimate(qs)
    want = ref_backend.estimate([ref_types.CostQuery(spec=ref_spec, bs=q.bs, stage=q.stage)
                                 for q in qs])
    assert (e2.hits, e2.misses) == (0, 4) and got[2].phi_ms != uncal.phi_ms
    for a, b in zip(got, want):
        assert a.to_dict() == b.to_dict()
    assert CostEngine(backend, cache=EstimateCache(path)).estimate_one(qs[0]).detail["cached"]


@pytest.mark.parametrize("ext", ["json", "npz"])
def test_fitted_spec_persists_across_packages(ground_truth, tmp_path, ext):
    mine, _ = ground_truth
    spec = calibrate(AnalyticalBackend(), _profiler(), WORKLOADS, datapoints=mine,
                     name="fit_roundtrip")
    path = str(tmp_path / f"spec.{ext}")
    save_device_spec(path, spec)
    ref_loaded = ref_devices.load_device_spec(path)
    loaded = load_device_spec(path)
    assert loaded.fingerprint() == ref_loaded.fingerprint() == spec.fingerprint()
    qs = [CostQuery(spec=w.build_model().conv_specs(), bs=4) for w in WORKLOADS[::4]]
    ref_qs = [ref_types.CostQuery(spec=w.build_model().conv_specs(), bs=4)
              for w in REF_WORKLOADS[::4]]
    got = AnalyticalBackend(device=path).estimate(qs)
    want = ref_backends.AnalyticalBackend(device=ref_loaded).estimate(ref_qs)
    assert [g.to_dict() for g in got] == [w.to_dict() for w in want]


# ---------------------------------------------------------------------------
# NNLS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_true", [[0.5, 0.0, 2.0], [2e-3, 1e-13, 5e-10], [0.0, 0.0, 1.0],
                                    [1.0, 2e-12, 3e-9, 0.0]])
def test_nnls_recovers_planted_coefficients(x_true):
    rng = np.random.default_rng(len(x_true))
    x_true = np.asarray(x_true)
    scales = [1.0, 1e12, 1e9, 1.0][: len(x_true)]
    A = np.stack([rng.uniform(0, 1, 40) * s if i else np.ones(40)
                  for i, s in enumerate(scales)], axis=1)
    x = nnls(A, A @ x_true)
    assert np.array_equal(x, ref_cal.nnls(A, A @ x_true))
    assert (x >= 0).all()
    np.testing.assert_allclose(x, x_true, rtol=1e-6, atol=1e-8 * np.abs(x_true).max())


@pytest.mark.parametrize("seed", range(4))
def test_nnls_identical_on_correlated_and_negative_systems(seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(1e9, 1e12, size=30)
    A = np.stack([np.ones(30), base, base * rng.uniform(0.5, 2.0, size=30)], axis=1)
    for b in (rng.uniform(1e-3, 1e-1, size=30), -rng.uniform(0, 1, size=30)):
        x = nnls(A, b)
        assert np.array_equal(x, ref_cal.nnls(A, b)) and (x >= 0).all()
