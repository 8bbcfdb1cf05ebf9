"""The port's paper runners (``repro_torch.bench``) against the reference's
(``benchmarks/``) on one synthetic profiling cache.

The cache is made from a numpy seed in the reference's JSON format at the
reference runners' geometry (width 0.25, 16x16, batch sizes 2, 8, 16, 32):
every key the six runners read, with the features of the real pruned
topologies and Γ/Φ drawn as noisy smooth functions of them; Table 2's
sub-network file likewise.  Each reference runner reads it through its
module constants (monkeypatched), the port's through its arguments, with
profiling made to raise in both packages, so a missing key fails instead
of profiling.  The printed CSV lines are framework-free, so they are held
equal as strings; Table 2's ``search_time_s`` lines carry host-clock
times, so there only the names and the profiling estimate are held.
"""

import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

import benchmarks.common as ref_common
import benchmarks.table2_case_study as ref_table2
from repro_torch.bench import common, run as bench_run
from repro_torch.bench import strategy_variation, table2_case_study
from repro_torch.bench.collect_cnn_data import all_grids
from repro_torch.core import dataset, features, profiler
from repro_torch.core.search import sample_subnetwork
from repro_torch.models.cnn import build_resnet50
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

GEO = common.REFERENCE
RUNNERS = {
    "fig3": "fig3_same_network",
    "fig4": "fig4_basis",
    "trainset": "trainset_sweep",
    "dnnmem": "dnnmem_comparison",
    "strategies": "strategy_variation",
    "table2": "table2_case_study",
}


def _targets(rng, f):
    """Γ (MB) and Φ (ms), smooth in the features, with 5% noise."""
    g, p = 1 + 0.05 * rng.standard_normal(2)
    return 2.0 + f[4] / 1e6 * g, 2.0 + f[14] / 1e7 * p


def _write_cache(path, rng):
    """Every grid the six runners read (``all_grids``) and the strategy
    points, at the reference geometry."""
    data = {}
    for spec in all_grids(GEO):
        for level in spec.levels:
            net = dataset._build_pruned(spec, level).conv_specs()
            for bs in spec.batch_sizes:
                f = features.network_features(net, bs)
                g, p = _targets(rng, f)
                dp = dataset.Datapoint(
                    family=spec.family, level=level, strategy=spec.strategy, bs=bs,
                    width_mult=spec.width_mult, input_hw=spec.input_hw, seed=spec.seed,
                    gamma_mb=float(g), phi_ms=float(p), features=[float(v) for v in f])
                data[dp.key] = dataclasses.asdict(dp)
    for i, m in enumerate(strategy_variation.strategy_models(GEO)):
        f = features.network_features(m.conv_specs(), strategy_variation.BS)
        g, p = _targets(rng, f)
        dp = dataset.Datapoint(
            family="mobilenetv2", level=strategy_variation.LEVEL, strategy=f"strat{i}",
            bs=strategy_variation.BS, width_mult=GEO.width_mult, input_hw=GEO.input_hw,
            seed=0, gamma_mb=float(g), phi_ms=float(p), features=[float(v) for v in f])
        data[dp.key] = dataclasses.asdict(dp)
    with open(path, "w") as fh:
        json.dump(data, fh)


def _write_subnets(path, rng):
    base = build_resnet50(width_mult=GEO.width_mult, input_hw=GEO.input_hw)
    rows = []
    for i in range(table2_case_study.N_TRAIN_SUB + table2_case_study.N_TEST_SUB):
        m = build_resnet50(widths=sample_subnetwork(base.widths,
                                                    np.random.default_rng(2000 + i)),
                           input_hw=GEO.input_hw)
        spec = m.conv_specs()
        for bs, train in [(b, False) for b in table2_case_study.INFER_BS] + [(16, True)]:
            f = features.network_features(spec, bs)
            g, p = _targets(rng, f)
            row = {"sub": i, "bs": bs, "gamma": float(g if train else g / 3),
                   "phi": float(p), "features": [float(v) for v in f],
                   "profile_s": float(rng.uniform(0.5, 2.0))}
            if train:
                row["train"] = True
            rows.append(row)
    with open(path, "w") as fh:
        json.dump(rows, fh)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    rng = np.random.default_rng(0)
    paths = {"cache": str(root / "cnn_profile.json"), "sub": str(root / "ofa_subnets.json")}
    _write_cache(paths["cache"], rng)
    _write_subnets(paths["sub"], rng)
    return paths


def _refuse(*args, **kwargs):
    raise AssertionError("a runner tried to profile: a key is missing from the cache")


@pytest.fixture
def no_profiling(monkeypatch):
    from repro.core import dataset as ref_dataset
    from repro.core import profiler as ref_profiler

    import benchmarks.strategy_variation as ref_strategies

    for mod in (ref_profiler, ref_table2, profiler):
        monkeypatch.setattr(mod, "profile_training", _refuse)
        monkeypatch.setattr(mod, "profile_inference", _refuse)
    for mod in (ref_dataset, ref_strategies, dataset):
        monkeypatch.setattr(mod, "profile_training", _refuse)


def _plain(x):
    """A runner's return value with dataclasses as dicts, for comparing
    the two packages' results."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _untimed(lines):
    """Table 2's lines with each search's host-clock time and speed-up cut
    out (the search itself is held by its ``fitness`` line)."""
    out = []
    for line in lines:
        name, value, derived = line.split(",")
        if name.endswith("/search_time_s"):
            value, derived = "-", derived.split(" ")[0]      # naive=<evals x profile>s
        out.append((name, value, derived))
    return out


@pytest.mark.parametrize("name", list(RUNNERS))
def test_runner_prints_the_reference_lines(name, synthetic, no_profiling, monkeypatch):
    ref = importlib.import_module(f"benchmarks.{RUNNERS[name]}")
    port = importlib.import_module(f"repro_torch.bench.{RUNNERS[name]}")
    monkeypatch.setattr(ref_common, "CACHE_PATH", synthetic["cache"])
    monkeypatch.setattr(ref_table2, "SUB_CACHE", synthetic["sub"])
    want, got = [], []
    want_out = ref.run(print_fn=want.append)
    kw = dict(cache_path=synthetic["cache"], geometry=GEO, device="cpu")
    if name == "table2":
        kw["sub_cache"] = synthetic["sub"]
    got_out = port.run(print_fn=got.append, **kw)
    assert len(got) == len(want) > 0
    if name == "table2":
        assert _untimed(got) == _untimed(want)
        for out in (got_out, want_out):
            for tier in ("ES_A", "ES_B"):
                for key in ("time_s", "speedup", "evals_per_s"):
                    assert np.isfinite(out[tier].pop(key))
    else:
        assert got == want
    assert _plain(got_out) == _plain(want_out)
    # every figure is finite
    assert all(np.isfinite(float(line.split(",")[1])) for line in got)


def test_runner_profiles_a_missing_point_into_its_cache(synthetic, tmp_path):
    """dnnmem over the synthetic cache less one ResNet-50 test point: the
    runner profiles that one point on the CPU and writes it to the cache."""
    spec = dataset.GridSpec("resnet50", dataset.DEFAULT_TEST_LEVELS, "random",
                            GEO.batch_sizes, GEO.width_mult, GEO.input_hw)
    missing = dataset.Datapoint(family="resnet50", level=spec.levels[0], strategy="random",
                                bs=2, width_mult=GEO.width_mult, input_hw=GEO.input_hw,
                                seed=0, gamma_mb=0, phi_ms=0).key
    path = str(tmp_path / "cnn_profile.json")
    with open(synthetic["cache"]) as fh:
        data = json.load(fh)
    del data[missing]
    with open(path, "w") as fh:
        json.dump(data, fh)
    fast = dataclasses.replace(GEO, repeats=1, warmup=0)
    lines = []
    err = importlib.import_module("repro_torch.bench.dnnmem_comparison").run(
        print_fn=lines.append, cache_path=path, geometry=fast, device="cpu")
    assert np.isfinite(err) and len(lines) == 1
    assert lines[0].startswith("dnnmem/resnet50/gamma_err_pct,")
    written = dataset.DatasetCache(path)
    assert len(written) == len(data) + 1
    dp = written.get(missing)
    assert dp.gamma_mb > 0 and dp.phi_ms > 0 and np.isfinite([dp.gamma_mb, dp.phi_ms]).all()
    assert len(dp.features) == 42


@pytest.mark.parametrize("name", list(RUNNERS) + ["collect"])
def test_runner_default_device_raises_without_cuda(name, monkeypatch, tmp_path):
    if name == "collect":
        from repro_torch.bench.collect_cnn_data import collect as call
    else:
        call = importlib.import_module(f"repro_torch.bench.{RUNNERS[name]}").run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(cache_path=str(tmp_path / "c.json"))
    assert not (tmp_path / "c.json").exists()


@pytest.mark.parametrize("name", ["roofline"])
def test_run_names_the_roadmap_item_of_a_bench_not_ported(name, capsys, monkeypatch,
                                                          tmp_path):
    """No bench is left unported: ``--only roofline`` prints the roofline
    table of the dry-run's ledger, line for line as the reference's
    ``benchmarks/roofline_table.py`` prints the same records."""
    import json

    from benchmarks import roofline_table as ref_table
    from repro_torch.bench import roofline_table

    assert bench_run.NOT_PORTED == {}
    cell = {"arch": "qwen3-4b", "shape": "train_4k", "mesh": "16x16", "compute_s": 0.51,
            "memory_s": 4.2, "collective_s": 0.3, "dominant": "memory", "step_s": 4.2,
            "useful_ratio": 0.61, "per_device_hbm_gb": 7.25, "fits_hbm": True}
    recs = [cell, {**cell, "mesh": "2x16x16", "fits_hbm": False},
            {"arch": "qwen3-4b", "shape": "long_500k", "mesh": "16x16", "skipped": "why"},
            {"arch": "mamba2-780m", "shape": "train_4k", "mesh": "16x16", "failed": True}]
    ledger = tmp_path / "dryrun.jsonl"
    ledger.write_text("".join(json.dumps(r) + "\n" for r in recs))
    monkeypatch.setattr(roofline_table, "DRYRUN_PATH", str(ledger))
    bench_run.main(["--only", name, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    mine = out[out.index(f"=== {name} ===") + 1:-1]
    monkeypatch.setattr(ref_table, "load_reports", lambda: [dict(r) for r in recs])
    theirs = []
    ref_table.run(theirs.append)
    assert mine == theirs and len(theirs) == 7


def test_collect_grids_are_the_reference_grids():
    """``all_grids`` at the reference geometry is the reference's list."""
    from benchmarks.collect_cnn_data import all_grids as ref_all_grids

    assert [dataclasses.astuple(g) for g in all_grids(GEO)] == \
        [dataclasses.astuple(g) for g in ref_all_grids()]
    full = all_grids()
    assert {(g.width_mult, g.input_hw, g.batch_sizes) for g in full} == \
        {(1.0, 32, common.GRID_BS)}
    assert sum(len(g.levels) for g in full) == 92       # topologies to profile


def test_budget_tiers_bind_and_nest():
    """The full-width budget rule on a synthetic estimate: each tier leaves
    at least ``FEASIBLE_FIRST`` first candidates feasible, B lies inside A,
    and each budget is at least the quantile of the measurements."""
    from repro_torch.engine.types import CostEstimate

    def estimate(queries):
        return [CostEstimate(gamma_mb=float(len(q.spec.layers) + sum(l.m for l in q.spec.layers)),
                             phi_ms=1.0 + sum(l.m for l in q.spec.layers) / 1e3)
                for q in queries]

    measured = np.random.default_rng(0).uniform(1.0, 2000.0, size=(3, 16))
    tiers, notes, best_first, pred = table2_case_study.budget_tiers(
        estimate, measured, width_mult=0.25, input_hw=16)
    assert set(tiers) == set(notes) == {"A", "B"} and pred.shape == (32, 3)
    a, b = ([t.gamma_mb, t.gamma_inf_mb, t.phi_inf_ms] for t in tiers.values())
    assert all(y <= x for x, y in zip(a, b))
    for budget in (a, b):
        assert (pred <= budget).all(axis=1).sum() >= table2_case_study.FEASIBLE_FIRST
    assert np.all(np.array(a) >= np.percentile(measured, 50, axis=1))
    assert best_first["MAX"] >= best_first["A"] >= best_first["B"]


def test_reference_geometry_takes_the_reference_profilers_steps():
    """At ``REFERENCE`` the grids take ``collect_grid``'s and
    ``profile_training``'s default steps and Table 2's inference profiles
    ``profile_inference``'s, as the reference runners do."""
    import inspect

    from repro.core import profiler as ref_profiler

    def defaults(fn):
        sig = inspect.signature(fn).parameters
        return {k: sig[k].default for k in ("repeats", "warmup")}

    assert GEO.profile_kw == defaults(ref_profiler.profile_training)
    assert GEO.infer_kw == defaults(ref_profiler.profile_inference)
    assert common.FULL.infer_kw == {"repeats": 10, "warmup": 2}


def test_table2_profiles_subnets_with_the_geometry_steps(monkeypatch, tmp_path):
    """Table 2's sub-network data: inference profiles take ``infer_kw``,
    the training point per sub-network ``profile_kw``; one row each, all
    written to the sub-network cache."""
    geo = dataclasses.replace(GEO, repeats=4, warmup=3, infer_repeats=7, infer_warmup=5)
    calls = []

    def fake(stage):
        def prof(model, bs, **kw):
            calls.append((stage, kw.pop("repeats"), kw.pop("warmup")))
            assert str(kw.pop("device")) == "cpu" and not kw
            return profiler.ProfileResult(gamma_mb=1.0, phi_ms=1.0, compile_s=0.0, flops=None)
        return prof

    monkeypatch.setattr(profiler, "profile_inference", fake("infer"))
    monkeypatch.setattr(profiler, "profile_training", fake("train"))
    path = str(tmp_path / "subs.json")
    rows, made = table2_case_study.subnet_inference_data(path, geo, "cpu")
    n_sub = table2_case_study.N_TRAIN_SUB + table2_case_study.N_TEST_SUB
    assert made == len(rows) == len(calls) == n_sub * (len(table2_case_study.INFER_BS) + 1)
    assert {c for c in calls if c[0] == "infer"} == {("infer", 7, 5)}
    assert {c for c in calls if c[0] == "train"} == {("train", 4, 3)}
    with open(path) as fh:
        assert json.load(fh) == rows


def test_gamma_witness_measures_the_sweeps_topologies_on_the_cpu(monkeypatch):
    """The Γ witness profiles the §6.1 sweep's own AlexNet topologies; on
    the CPU it gives Γ and Φ and no allocator peaks, and its default
    device raises without CUDA."""
    from repro_torch.bench import gamma_witness

    assert {lv for lv, _ in gamma_witness.POINTS} <= set(dataset.PAPER_ALL_LEVELS)
    fast = dataclasses.replace(GEO, repeats=1, warmup=0)
    rows = gamma_witness._readings(gamma_witness.POINTS[1:2], True, False, fast, "cpu")
    (row,) = rows
    assert row["process"] == "fresh" and row["bs"] == 256
    assert row["gamma_mb"] > row["arg_mb"] > 0 and row["phi_ms"] > 0
    assert row["peak_requested_mb"] is None and row["peak_allocated_mb"] is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gamma_witness.measure(*gamma_witness.POINTS[0], fast)
