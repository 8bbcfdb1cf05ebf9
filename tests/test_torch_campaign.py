"""The port's profiling campaign (``repro_torch.campaign``) against the
reference's (``repro.campaign``): planning, resumable running, fitting,
the engine wiring, the CLI and the launcher's ``--lm-forest``.

The classes mirror ``tests/test_campaign.py`` case by case, on the port
(the reference's dry-run ledger case is in ``tests/test_torch_dryrun.py``
with the port's dry run).  The ``Parity*`` classes hold the two
packages together on identical inputs.  Everything but a measurement is
framework-free and held exactly (``==``): plans, plan hashes, cell keys,
skip reasons, ledgers, features, forest predictions and ``meta``, fitted
constants, CLI output, admission decisions.  A measurement is held by its
written definition (``measure_cell``): finite and positive, the
reference's keys, and the FLOPs of its traced ledger equal to the
reference's HLO count.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading

import numpy as np
import pytest

from repro.campaign import fit as ref_fit
from repro.campaign import lm_features as ref_lmf
from repro.campaign import plan as ref_plan
from repro.campaign import runner as ref_runner
from repro.configs import base as ref_base
from repro.engine import backends as ref_backends
from repro.engine import devices as ref_devices
from repro.engine import engine as ref_engine
from repro.engine import types as ref_types
from repro_torch.campaign import (
    CampaignCell,
    CampaignLedger,
    CampaignRunner,
    LMForest,
    fit_hlo_constants,
    fit_lm_forest,
    plan_grid,
    register_lm_forest,
    smoke_plan,
)
from repro_torch.campaign import fit as port_fit
from repro_torch.campaign import plan as port_plan
from repro_torch.campaign import lm_features as lmf
from repro_torch.campaign.plan import (
    SMOKE_SHAPES,
    collective_smoke_plan,
    load_plan,
    mesh_dims,
    resolve_shape,
)
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.fileio import append_jsonl, load_jsonl_tolerant
from repro_torch.engine import CostEngine, CostQuery, devices
from repro_torch.engine.backends import AnalyticalBackend, EnsembleBackend, ForestBackend
from tests._torch_host import port_host_share  # noqa: F401 (autouse)


def fake_measure(cell) -> dict:
    """Deterministic ground-truth stand-in (the reference test's): targets
    are smooth functions of the cell geometry, so forests have signal and
    re-runs are bit-equal.  Takes either package's cell."""
    t = cell.shape.tokens
    train = cell.shape.kind == "train"
    flops = 1e6 * t * (3.0 if train else 1.0)
    hbm = 2e5 * t
    mm_bytes = 0.5 * hbm  # exact halving: the two classes re-sum bit-exactly
    return {
        "gamma_mb": 8.0 + 0.02 * t + (4.0 if train else 0.0),
        "phi_ms": 1.0 + 0.004 * t * (3.0 if train else 1.0),
        "compile_s": 0.0,
        "flops": flops,
        "hbm_bytes": hbm,
        "collective_bytes": 0.0,
        "cost_classes": {
            "matmul": {"flops": flops, "hbm_bytes": mm_bytes,
                       "collective_bytes": 0.0, "count": 4},
            "elementwise": {"flops": 0.0, "hbm_bytes": hbm - mm_bytes,
                            "collective_bytes": 0.0, "count": 9},
        },
        "temp_mb": 1.0, "arg_mb": 1.0, "n_devices": 1, "executed": True,
    }


def run_fake_campaign(plan, ledger_path, **kw):
    runner = CampaignRunner(plan, ledger_path, measure=fake_measure, **kw)
    return runner, runner.run_campaign()


def _ref_shape(s):
    return ref_base.ShapeSpec(s.name, s.seq_len, s.global_batch, s.kind)


def _ref_spec(spec):
    """The port's DeviceSpec as the reference's (``h100`` is not there)."""
    return ref_devices.DeviceSpec.from_dict(spec.to_dict())


# ---------------------------------------------------------------------------
# fileio: the durable-append ledger contract
# ---------------------------------------------------------------------------


class TestJsonlFileio:
    def test_roundtrip_and_append(self, tmp_path):
        p = str(tmp_path / "l.jsonl")
        assert load_jsonl_tolerant(p) == []
        append_jsonl(p, {"a": 1})
        append_jsonl(p, [{"b": 2}, {"c": 3}])
        assert load_jsonl_tolerant(p) == [{"a": 1}, {"b": 2}, {"c": 3}]

    def test_torn_final_line_dropped(self, tmp_path):
        p = str(tmp_path / "l.jsonl")
        append_jsonl(p, [{"a": 1}, {"b": 2}])
        with open(p, "a") as f:
            f.write('{"torn": tru')  # crash mid-append
        assert load_jsonl_tolerant(p) == [{"a": 1}, {"b": 2}]
        append_jsonl(p, {"d": 4})
        recs = load_jsonl_tolerant(p)
        assert {"d": 4} in recs and len(recs) == 3

    def test_non_dict_rows_ignored(self, tmp_path):
        p = str(tmp_path / "l.jsonl")
        with open(p, "w") as f:
            f.write('[1,2]\n"str"\n{"ok": 1}\n\n')
        assert load_jsonl_tolerant(p) == [{"ok": 1}]


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


class TestPlan:
    def test_reproducible_hash(self):
        a = smoke_plan(subsample=4, seed=7)
        b = smoke_plan(subsample=4, seed=7)
        assert a.plan_hash == b.plan_hash
        assert [c.key for c in a.cells] == [c.key for c in b.cells]
        assert a.plan_hash != smoke_plan(subsample=4, seed=8).plan_hash

    def test_stratified_subsample_covers_archs(self):
        plan = smoke_plan(subsample=4, seed=0)
        assert {c.arch for c in plan.cells} == {"qwen3-4b", "stablelm-1.6b"}

    def test_unsupported_cells_skipped(self):
        plan = plan_grid(archs=("qwen3-4b",), shapes=("smoke_train_16x2",),
                         meshes=("4x1",))
        assert len(plan.cells) == 0
        assert plan.skipped and "not divisible" in plan.skipped[0]["why"]

    def test_save_load_and_tamper_detection(self, tmp_path):
        plan = smoke_plan(subsample=3, seed=0)
        p = str(tmp_path / "plan.json")
        plan.save(p)
        loaded = load_plan(p)
        assert loaded.plan_hash == plan.plan_hash
        assert loaded.cells == plan.cells
        blob = json.load(open(p))
        blob["cells"] = blob["cells"][1:]
        json.dump(blob, open(p, "w"))
        with pytest.raises(ValueError, match="inconsistent"):
            load_plan(p)

    def test_mesh_dims(self):
        assert mesh_dims("2x16x16") == (2, 16, 16)
        with pytest.raises(ValueError):
            mesh_dims("banana")


# The plans held against the reference: the smoke grids, the production
# shapes over the meshes the planner prices, full and reduced, subsampled
# by count and by fraction, and the card campaign's own grid.
CARD_SHAPES = tuple(
    [ShapeSpec(f"train_b{b}_s2048", 2048, b, "train") for b in (1, 2, 4)]
    + [ShapeSpec(f"prefill_b{b}_s2048", 2048, b, "prefill") for b in (1, 2, 4, 8)]
    + [ShapeSpec(f"decode_b{b}_s2048", 2048, b, "decode") for b in (8, 32)])
PLANS = {
    "smoke": lambda m: m.smoke_plan(),
    "smoke_sub4_seed7": lambda m: m.smoke_plan(subsample=4, seed=7),
    "smoke_sub6": lambda m: m.smoke_plan(subsample=6, seed=0),
    "collective": lambda m: m.collective_smoke_plan(),
    "production_meshes": lambda m: m.plan_grid(
        meshes=("1x1", "2x1", "1x2", "16x16", "2x16x16", "4x1"), device="tpu_v5e",
        reduced=False),
    "production_frac": lambda m: m.plan_grid(
        meshes=("16x16", "2x16x16"), reduced=False, subsample=0.3, seed=3),
    "smoke_all_archs_sub": lambda m: m.plan_grid(
        shapes=tuple(SMOKE_SHAPES), meshes=("1x1", "2x1"), subsample=25, seed=11),
    "card": lambda m: m.plan_grid(
        ("stablelm-1.6b", "internlm2-1.8b", "qwen3-4b", "mamba2-780m"),
        CARD_SHAPES if m is not ref_plan else tuple(_ref_shape(s) for s in CARD_SHAPES),
        meshes=("1x1",), device="h100", reduced=False, subsample=20, seed=0),
}


class TestParityPlan:
    @pytest.mark.parametrize("name", list(PLANS))
    def test_plans_hashes_keys_and_skips_as_reference(self, name):
        mine, ref = PLANS[name](port_plan), PLANS[name](ref_plan)
        assert mine.plan_hash == ref.plan_hash
        assert [c.key for c in mine.cells] == [c.key for c in ref.cells]
        assert [c.to_dict() for c in mine.cells] == [c.to_dict() for c in ref.cells]
        assert mine.skipped == ref.skipped and mine.meta == ref.meta
        assert len(mine) == len(ref) > 0

    @pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
    def test_plan_files_load_across_packages(self, tmp_path, direction):
        p = str(tmp_path / "plan.json")
        writer, reader = ((port_plan, ref_plan) if direction == "port_to_reference"
                          else (ref_plan, port_plan))
        plan = PLANS["production_meshes"](writer)
        plan.save(p)
        loaded = reader.load_plan(p)
        assert loaded.plan_hash == plan.plan_hash
        assert [c.key for c in loaded.cells] == [c.key for c in plan.cells]
        blob = json.load(open(p))
        blob["seed"] = 1
        json.dump(blob, open(p, "w"))
        for mod in (ref_plan, port_plan):   # tamper refused by both
            with pytest.raises(ValueError, match="inconsistent"):
                mod.load_plan(p)

    def test_smoke_shapes_and_resolve_shape(self):
        assert {k: dataclasses.astuple(v) for k, v in SMOKE_SHAPES.items()} == \
            {k: dataclasses.astuple(v) for k, v in ref_plan.SMOKE_SHAPES.items()}
        for name in list(SHAPES) + list(SMOKE_SHAPES):
            assert dataclasses.astuple(resolve_shape(name)) == \
                dataclasses.astuple(ref_plan.resolve_shape(name))
        for mod in (ref_plan, port_plan):
            with pytest.raises(KeyError, match="unknown shape"):
                mod.resolve_shape("nope")
        for desc in ("1x1", "2x16x16", "7"):
            assert mesh_dims(desc) == ref_plan.mesh_dims(desc)
        for bad in ("banana", "0x2", ""):
            with pytest.raises(ValueError):
                ref_plan.mesh_dims(bad)
            with pytest.raises(ValueError):
                mesh_dims(bad)

    def test_cell_key_is_the_reference_sha1(self):
        for arch in ARCH_IDS:
            for s in CARD_SHAPES + tuple(SMOKE_SHAPES.values()):
                for mesh in ("1x1", "2x16x16"):
                    for device, reduced in (("h100", False), ("host_cpu", True)):
                        c = CampaignCell(arch, s, mesh, device, reduced)
                        r = ref_plan.CampaignCell(arch, _ref_shape(s), mesh, device, reduced)
                        assert c.key == r.key
                        assert CampaignCell.from_dict(r.to_dict()) == c


# ---------------------------------------------------------------------------
# runner: resume semantics
# ---------------------------------------------------------------------------


class TestRunnerResume:
    def test_interrupted_run_resumes_without_remeasuring(self, tmp_path):
        plan = smoke_plan(subsample=6, seed=0)
        led = str(tmp_path / "ledger.jsonl")
        calls: list[str] = []

        def counting(cell):
            calls.append(cell.key)
            return fake_measure(cell)

        r1 = CampaignRunner(plan, led, measure=counting)
        out1 = r1.run_campaign(max_cells=2)
        assert out1["measured"] == 2 and out1["remaining"] == len(plan) - 2
        with open(led, "a") as f:
            f.write('{"key": "half-writ')
        r2 = CampaignRunner(plan, led, measure=counting)
        out2 = r2.run_campaign()
        assert out2["measured"] == len(plan) - 2
        assert out2["remaining"] == 0
        assert len(calls) == len(set(calls)) == len(plan)
        _, out3 = run_fake_campaign(plan, led)
        assert out3["measured"] == 0 and out3["failed"] == 0

    def test_final_ledger_equals_uninterrupted_run(self, tmp_path):
        plan = smoke_plan(subsample=6, seed=0)
        a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
        for max_cells in (2, 3, None):
            CampaignRunner(plan, a, measure=fake_measure).run_campaign(
                max_cells=max_cells)
        run_fake_campaign(plan, b)
        rec_a = {r["key"]: r for r in CampaignLedger(a).records()}
        rec_b = {r["key"]: r for r in CampaignLedger(b).records()}
        assert rec_a == rec_b

    def test_quarantine_persists_and_is_not_retried(self, tmp_path):
        plan = smoke_plan(subsample=6, seed=0)
        led = str(tmp_path / "ledger.jsonl")
        poison = plan.cells[2].key
        attempts: list[str] = []

        def flaky(cell):
            attempts.append(cell.key)
            if cell.key == poison:
                raise RuntimeError("unlowerable layout")
            return fake_measure(cell)

        out1 = CampaignRunner(plan, led, measure=flaky).run_campaign()
        assert out1["failed"] == 1 and out1["remaining"] == 0
        assert CampaignLedger(led).failed_keys == {poison}
        rec = CampaignLedger(led).get(poison)
        assert rec["status"] == "failed" and "unlowerable" in rec["error"]
        assert CampaignRunner(plan, led, measure=flaky).run_campaign()["measured"] == 0
        assert attempts.count(poison) == 1
        r3 = CampaignRunner(plan, led, measure=fake_measure, retry_failed=True)
        assert r3.run_campaign()["measured"] == 1
        assert CampaignLedger(led).failed_keys == set()

    def test_hung_cell_quarantined_as_timeout(self, tmp_path):
        plan = smoke_plan(subsample=4, seed=0)
        led = str(tmp_path / "ledger.jsonl")
        hung_key = plan.cells[1].key
        release = threading.Event()

        def hang(cell):
            if cell.key == hung_key:
                release.wait(30.0)
            return fake_measure(cell)

        out = CampaignRunner(plan, led, measure=hang, cell_timeout_s=0.2).run_campaign()
        release.set()
        assert out["measured"] == len(plan) - 1
        assert out["failed"] == 1 and out["remaining"] == 0
        rec = CampaignLedger(led).get(hung_key)
        assert rec["status"] == "failed" and rec["error"] == "timeout"
        r2 = CampaignRunner(plan, led, measure=fake_measure, cell_timeout_s=0.2)
        assert r2.run_campaign()["measured"] == 0
        r3 = CampaignRunner(plan, led, measure=fake_measure, cell_timeout_s=0.2,
                            retry_failed=True)
        assert r3.run_campaign()["measured"] == 1
        assert CampaignLedger(led).failed_keys == set()

    def test_shards_partition_the_grid(self, tmp_path):
        plan = smoke_plan(seed=0)
        led = str(tmp_path / "ledger.jsonl")
        runner = CampaignRunner(plan, led, measure=fake_measure)
        shards = [runner.shard_cells(i, 3) for i in range(3)]
        keys = [c.key for s in shards for c in s]
        assert sorted(keys) == sorted(c.key for c in plan.cells)
        CampaignRunner(plan, led, measure=fake_measure).run_campaign(0, 2)
        CampaignRunner(plan, led, measure=fake_measure).run_campaign(1, 2)
        assert CampaignLedger(led).ok_keys == {c.key for c in plan.cells}


def _both_ledgers(tmp_path, drive):
    """Run ``drive(runner_cls, plan, path)`` in each package over the same
    smoke plan; return (port records, reference records) in file order."""
    out = []
    for tag, runner_cls, plan in (("port", CampaignRunner, smoke_plan(seed=0)),
                                  ("ref", ref_runner.CampaignRunner,
                                   ref_plan.smoke_plan(seed=0))):
        path = str(tmp_path / f"{tag}.jsonl")
        summaries = drive(runner_cls, plan, path)
        out.append((load_jsonl_tolerant(path), summaries))
    return out


class TestParityRunner:
    def test_resume_and_shards_give_the_reference_ledger(self, tmp_path):
        def drive(runner_cls, plan, path):
            s = [runner_cls(plan, path, measure=fake_measure).run_campaign(max_cells=3),
                 runner_cls(plan, path, measure=fake_measure).run_campaign(0, 2),
                 runner_cls(plan, path, measure=fake_measure).run_campaign(1, 2),
                 runner_cls(plan, path, measure=fake_measure).run_campaign()]
            return s + [[c.key for c in runner_cls(plan, path, measure=fake_measure)
                         .shard_cells(i, 3)] for i in range(3)]

        (mine, ms), (ref, rs) = _both_ledgers(tmp_path, drive)
        assert mine == ref and ms == rs and len(mine) == 16

    def test_quarantine_and_timeout_give_the_reference_ledger(self, tmp_path):
        release = threading.Event()

        def drive(runner_cls, plan, path):
            poison, hung = plan.cells[2].key, plan.cells[5].key

            def flaky(cell):
                if cell.key == poison:
                    raise RuntimeError("unlowerable layout")
                if cell.key == hung:
                    release.wait(30.0)
                return fake_measure(cell)

            s = [runner_cls(plan, path, measure=flaky, cell_timeout_s=0.2).run_campaign(),
                 runner_cls(plan, path, measure=flaky).run_campaign(),
                 runner_cls(plan, path, measure=fake_measure,
                            retry_failed=True).run_campaign(max_cells=1)]
            return s

        try:
            (mine, ms), (ref, rs) = _both_ledgers(tmp_path, drive)
        finally:
            release.set()
        strip = lambda recs: [{k: v for k, v in r.items() if k != "trace"}  # noqa: E731
                              for r in recs]
        assert strip(mine) == strip(ref) and ms == rs
        assert [r["error"] for r in mine if r["status"] == "failed"] == \
            ["RuntimeError: unlowerable layout", "timeout"]

    def test_ledger_schema_and_views(self, tmp_path):
        assert port_runner_schema() == ref_runner.LEDGER_SCHEMA_VERSION == 4
        plan = smoke_plan(subsample=4, seed=0)
        led = str(tmp_path / "l.jsonl")
        run_fake_campaign(plan, led)
        mine, ref = CampaignLedger(led), ref_runner.CampaignLedger(led)
        assert mine.records() == ref.records() and len(mine) == len(ref) == 4
        assert mine.ok_keys == ref.ok_keys and mine.failed_keys == ref.failed_keys
        assert mine.records("failed") == ref.records("failed") == []


def port_runner_schema():
    from repro_torch.campaign.runner import LEDGER_SCHEMA_VERSION

    return LEDGER_SCHEMA_VERSION


# ---------------------------------------------------------------------------
# fit: forests, constants, persistence
# ---------------------------------------------------------------------------


def _fitted(tmp_path, n=12):
    plan = smoke_plan(subsample=n, seed=0)
    led = str(tmp_path / "ledger.jsonl")
    runner, _ = run_fake_campaign(plan, led)
    records = runner.ledger.records("ok")
    return records, fit_lm_forest(records, holdout_frac=0.25, seed=0)


class TestFit:
    def test_forest_learns_the_fake_grid(self, tmp_path):
        records, forest = _fitted(tmp_path)
        assert forest.fitted
        assert forest.meta["n_heldout"] >= 1
        assert forest.meta["holdout_phi_mape"] < 0.5
        assert forest.meta["holdout_gamma_mape"] < 0.5

    def test_save_load_roundtrip(self, tmp_path):
        records, forest = _fitted(tmp_path)
        q = [CostQuery(arch="qwen3-4b", bs=2, seq=32, stage="train")]
        want = forest.predict_queries(q)
        for ext in ("npz", "json"):
            path = str(tmp_path / f"forest.{ext}")
            forest.save(path)
            loaded = LMForest.load(path)
            got = loaded.predict_queries(q)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert loaded.meta["plan_hash"] == forest.meta["plan_hash"]
            assert loaded.content_hash() == forest.content_hash()

    def test_feature_drift_detected_on_load(self, tmp_path):
        records, forest = _fitted(tmp_path)
        path = str(tmp_path / "forest.json")
        forest.save(path)
        blob = json.load(open(path))
        blob["feature_names"] = blob["feature_names"][:-1]
        json.dump(blob, open(path, "w"))
        with pytest.raises(ValueError, match="different feature set"):
            LMForest.load(path)

    def test_hlo_constants_recovered(self, tmp_path):
        peak, bw, c0 = 2e9, 5e8, 3e-3
        rng = np.random.default_rng(0)
        records = []
        for i in range(10):
            fl = float(rng.uniform(1e6, 1e8))
            hb = float(rng.uniform(1e5, 1e7))
            records.append({
                "status": "ok", "device": "host_cpu", "plan_hash": "x",
                "flops": fl, "hbm_bytes": hb, "collective_bytes": 0.0,
                "phi_ms": (c0 + fl / peak + hb / bw) * 1e3,
            })
        spec = fit_hlo_constants(records)
        assert spec.calibrated and spec.combine == "sum"
        assert spec.peak_flops == pytest.approx(peak, rel=1e-4)
        assert spec.hbm_bw == pytest.approx(bw, rel=1e-4)
        assert spec.launch_overhead_s == pytest.approx(c0, rel=1e-4)
        assert spec.meta["phi_mape"] < 1e-6

    def test_register_walks_engine_and_ensemble(self, tmp_path):
        records, forest = _fitted(tmp_path)
        fb = ForestBackend()
        engine = CostEngine(EnsembleBackend([fb, AnalyticalBackend()]))
        owner = register_lm_forest(engine, forest)
        assert owner is fb and fb.lm is forest
        with pytest.raises(ValueError):
            register_lm_forest(EnsembleBackend([AnalyticalBackend()]), forest)
        with pytest.raises(TypeError):
            register_lm_forest(AnalyticalBackend(), forest)


# ---------------------------------------------------------------------------
# fit-time device-fingerprint guard
# ---------------------------------------------------------------------------


class TestFingerprintGuard:
    def _records(self, tmp_path, fingerprint=None):
        plan = smoke_plan(subsample=8, seed=0)
        runner, _ = run_fake_campaign(plan, str(tmp_path / "l.jsonl"))
        records = runner.ledger.records("ok")
        if fingerprint is not None:
            for r in records:
                r["device_fingerprint"] = fingerprint
        return records

    def test_matching_fingerprints_pass(self, tmp_path):
        from repro_torch.campaign.fit import check_device_fingerprints

        records = self._records(tmp_path, devices.get_device("host_cpu").fingerprint())
        out = check_device_fingerprints(records)
        assert out == {"checked": len(records), "unstamped": 0, "mismatched": 0}
        forest = fit_lm_forest(records, holdout_frac=0.25, seed=0)
        assert forest.meta["fingerprint_check"]["mismatched"] == 0

    def test_unstamped_legacy_records_pass(self, tmp_path):
        from repro_torch.campaign.fit import check_device_fingerprints

        records = self._records(tmp_path)
        out = check_device_fingerprints(records)
        assert out["unstamped"] == len(records) and out["checked"] == 0
        assert fit_lm_forest(records, holdout_frac=0.25, seed=0).fitted

    def test_stale_fingerprint_refused(self, tmp_path):
        records = self._records(tmp_path, "deadbeefdeadbeef")
        with pytest.raises(ValueError, match="different device constants"):
            fit_lm_forest(records, holdout_frac=0.25, seed=0)
        with pytest.raises(ValueError, match="different device constants"):
            fit_hlo_constants(records)

    def test_allow_mixed_opts_in(self, tmp_path):
        records = self._records(tmp_path, "deadbeefdeadbeef")
        forest = fit_lm_forest(records, holdout_frac=0.25, seed=0, allow_mixed=True)
        assert forest.fitted
        assert forest.meta["fingerprint_check"]["mismatched"] == len(records)
        assert fit_hlo_constants(records, allow_mixed=True).calibrated

    def test_device_override_trips_the_guard(self, tmp_path):
        records = self._records(tmp_path, devices.get_device("host_cpu").fingerprint())
        with pytest.raises(ValueError, match="different device constants"):
            fit_lm_forest(records, device="tpu_v5e", holdout_frac=0.25, seed=0)
        forest = fit_lm_forest(records, device="tpu_v5e", holdout_frac=0.25,
                               seed=0, allow_mixed=True)
        assert forest.meta["device"] == "tpu_v5e"

    def test_mixed_device_ledger_refused_for_hlo_fit(self):
        rng = np.random.default_rng(0)
        records = []
        for i in range(8):
            records.append({
                "status": "ok", "plan_hash": "x",
                "device": "host_cpu" if i % 2 else "tpu_v5e",
                "flops": float(rng.uniform(1e6, 1e8)),
                "hbm_bytes": float(rng.uniform(1e5, 1e7)),
                "collective_bytes": 0.0, "phi_ms": 1.0 + i,
            })
        with pytest.raises(ValueError, match="one device"):
            fit_hlo_constants(records)
        assert fit_hlo_constants(records, allow_mixed=True).calibrated
        for r in records:
            r["device"] = "host_cpu"
        assert fit_hlo_constants(records).calibrated

    def test_cli_allow_mixed_flag(self, tmp_path, monkeypatch, capsys):
        from repro_torch.campaign import __main__ as cli

        plan_path = str(tmp_path / "plan.json")
        assert cli.main(["plan", "--smoke", "--subsample", "6", "--out", plan_path]) == 0
        led = str(tmp_path / "ledger.jsonl")
        monkeypatch.setattr(
            "repro_torch.campaign.runner.measure_cell",
            lambda cell, **kw: {**fake_measure(cell),
                                "device_fingerprint": "stale00stale00"})
        assert cli.main(["run", "--plan", plan_path, "--ledger", led,
                         "--torch-device", "cpu"]) == 0
        out_path = str(tmp_path / "forest.json")
        with pytest.raises(ValueError, match="--allow-mixed"):
            cli.main(["fit", "--ledger", led, "--out", out_path])
        assert cli.main(["fit", "--ledger", led, "--out", out_path,
                         "--allow-mixed"]) == 0
        assert os.path.exists(out_path)
        capsys.readouterr()


# ---------------------------------------------------------------------------
# fit parity: the same records give the reference's forest and constants
# ---------------------------------------------------------------------------


def _fake_records(tmp_path, n=None, card=False):
    """ok-records of a fake campaign (the reference's fake targets), from
    the port's runner over the smoke plan, or over the card grid with the
    ``h100`` fingerprint stamped and per-class energy buckets."""
    if card:
        plan = PLANS["card"](port_plan)
    else:
        plan = smoke_plan(subsample=n, seed=0)
    led = str(tmp_path / "fake.jsonl")
    measure = fake_measure
    if card:
        fp = devices.get_device("h100").fingerprint()

        def measure(cell):  # noqa: F811 — energy and fingerprint stamped
            r = fake_measure(cell)
            r.update(device_fingerprint=fp, watts_proxy=300.0 + cell.shape.tokens / 100,
                     energy_j=0.3 * r["phi_ms"] + 1e-4 * cell.shape.tokens)
            for cls in r["cost_classes"].values():
                cls["energy_j"] = 1e-9 * cls["flops"] + 1e-12 * cls["hbm_bytes"]
            return r
    CampaignRunner(plan, led, measure=measure).run_campaign()
    return CampaignLedger(led).records("ok")


@pytest.fixture
def ref_h100(monkeypatch):
    """The card records name ``h100``, which the reference's registry
    lacks: the port's spec is registered there for the test only."""
    monkeypatch.setitem(ref_devices.DEVICE_REGISTRY, "h100",
                        _ref_spec(devices.get_device("h100")))


class TestParityFit:
    @pytest.mark.parametrize("kind", ["smoke", "card"])
    def test_forest_predictions_and_meta_as_reference(self, tmp_path, kind, ref_h100):
        records = _fake_records(tmp_path, 12 if kind == "smoke" else None,
                                card=kind == "card")
        mine = fit_lm_forest(records, holdout_frac=0.25, seed=0)
        ref = ref_fit.fit_lm_forest(records, holdout_frac=0.25, seed=0)
        assert mine.meta == ref.meta
        assert mine.energy_fitted == ref.energy_fitted == (kind == "card")
        X = lmf.feature_matrix(records)
        assert np.array_equal(X, ref_lmf.feature_matrix(records))
        for a, b in zip(mine.predict_features(X), ref.predict_features(X)):
            assert np.array_equal(a, b)
        qs = [(a, s, bs, seq) for a in ("qwen3-4b", "internlm2-1.8b", "mamba2-780m")
              for s in ("train", "infer") for bs, seq in ((1, 2048), (8, 512))]
        pq = [CostQuery(arch=a, bs=bs, seq=seq, stage=s) for a, s, bs, seq in qs]
        rq = [ref_types.CostQuery(arch=a, bs=bs, seq=seq, stage=s) for a, s, bs, seq in qs]
        for a, b in zip(mine.predict_queries(pq), ref.predict_queries(rq)):
            assert np.array_equal(a, b)
        assert np.array_equal(mine.predict_energy(pq), ref.predict_energy(rq))
        assert mine.content_hash() == ref.content_hash()

    @pytest.mark.parametrize("kind", ["smoke", "card"])
    def test_hlo_constants_as_reference(self, tmp_path, kind, ref_h100):
        records = _fake_records(tmp_path, 12 if kind == "smoke" else None,
                                card=kind == "card")
        for per_class in (True, False):
            mine = fit_hlo_constants(records, per_class=per_class)
            ref = ref_fit.fit_hlo_constants(records, per_class=per_class)
            assert mine.fingerprint() == ref.fingerprint()
            assert mine.to_dict() == ref.to_dict()

    def test_hlo_constants_with_an_inert_term_at_card_scale(self):
        """Card-scale records (1e13–3e14 FLOPs) on which NNLS zeroes the
        FLOP coefficient: the reference's self-check adds the inert term's
        column / 1e18 seconds and raises; the port's holds the whole sum
        within that addition and returns the spec the reference would have
        built (peak 1e18): its whole sum is the fitted system plus exactly
        FLOPs / 1e18, and its fitted terms reproduce the system's MAPE."""
        from repro_torch.engine.decompose import lm_roofline_terms

        rng = np.random.default_rng(0)
        records = []
        for _ in range(8):
            fl, hb = float(rng.uniform(1e13, 3e14)), float(rng.uniform(1e11, 4e12))
            records.append({"status": "ok", "device": "host_cpu", "plan_hash": "x",
                            "flops": fl, "hbm_bytes": hb, "collective_bytes": 0.0,
                            "phi_ms": (0.5 + hb / 2e12 - fl / 1e15) * 1e3})
        with pytest.raises(AssertionError):
            ref_fit.fit_hlo_constants(records)
        spec = fit_hlo_constants(records)
        assert spec.peak_flops == 1e18 and spec.ici_bw == 1e18 and spec.calibrated
        phi = np.array([r["phi_ms"] for r in records]) / 1e3
        flops = np.array([r["flops"] for r in records])
        hbm = np.array([r["hbm_bytes"] for r in records])
        flop_s, mem_s, coll_s = lm_roofline_terms(flops, hbm, 0.0, spec)
        fitted = spec.launch_overhead_s + mem_s
        whole = fitted + flop_s + coll_s
        np.testing.assert_allclose(whole - fitted, flops / 1e18, rtol=1e-6)
        assert float(np.max(whole - fitted)) > 1e-6 * float(np.min(fitted))
        assert spec.meta["phi_mape_aggregate"] == pytest.approx(
            float(np.mean(np.abs(fitted - phi) / phi)), rel=1e-9)

    def test_split_and_fingerprint_check_as_reference(self, tmp_path):
        records = _fake_records(tmp_path)
        for frac, seed in ((0.25, 0), (0.5, 3), (0.0, 1), (0.1, 2)):
            assert port_fit.split_records(records, holdout_frac=frac, seed=seed) == \
                ref_fit.split_records(records, holdout_frac=frac, seed=seed)
        stamped = [dict(r, device_fingerprint="0f" * 8) for r in records]
        for recs in (records, stamped):
            assert port_fit.check_device_fingerprints(recs, allow_mixed=True) == \
                ref_fit.check_device_fingerprints(recs, allow_mixed=True)

    @pytest.mark.parametrize("ext", ["npz", "json"])
    @pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
    def test_forest_files_load_across_packages(self, tmp_path, ext, direction, ref_h100):
        records = _fake_records(tmp_path, card=True)
        fitters = {"port": (fit_lm_forest, LMForest),
                   "ref": (ref_fit.fit_lm_forest, ref_fit.LMForest)}
        src, dst = (("port", "ref") if direction == "port_to_reference" else ("ref", "port"))
        forest = fitters[src][0](records, holdout_frac=0.25, seed=0)
        path = str(tmp_path / f"forest.{ext}")
        forest.save(path)
        loaded = fitters[dst][1].load(path)
        X = lmf.feature_matrix(records)
        for a, b in zip(loaded.predict_features(X), forest.predict_features(X)):
            assert np.array_equal(a, b)
        assert loaded.meta == forest.meta and loaded.energy_fitted
        assert loaded.content_hash() == forest.content_hash()


# ---------------------------------------------------------------------------
# features: every arch × shape × mesh × device, as the reference
# ---------------------------------------------------------------------------

FEATURE_MESHES = ((1, 1), (2, 1), (1, 2), (16, 16), (2, 16, 16))
FEATURE_DEVICES = ("host_cpu", "tpu_v5e", "h100")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_features_as_reference(arch):
    """``cell_features`` for ``SHAPES`` (full config) and ``SMOKE_SHAPES``
    (reduced) × the meshes × three devices, row for row."""
    assert lmf.LM_FEATURE_NAMES == ref_lmf.LM_FEATURE_NAMES
    assert lmf.CLASS_FEATURE_NAMES == ref_lmf.CLASS_FEATURE_NAMES
    from repro.configs.registry import get_config as ref_get_config

    for reduced, shapes in ((False, SHAPES), (True, SMOKE_SHAPES)):
        cfg, ref_cfg = get_config(arch, reduced=reduced), ref_get_config(arch, reduced=reduced)
        for s in list(shapes.values()) + list(CARD_SHAPES):
            for dims in FEATURE_MESHES:
                for name in FEATURE_DEVICES:
                    dev = devices.get_device(name)
                    mine = lmf.cell_features(cfg, s, dims, dev)
                    ref = ref_lmf.cell_features(ref_cfg, _ref_shape(s), dims, _ref_spec(dev))
                    assert np.array_equal(mine, ref), (s.name, dims, name)


def test_feature_matrix_and_class_histograms_as_reference(tmp_path, ref_h100):
    """``feature_matrix`` over ledger records (analytic and ledger class
    providers, a device override), ``class_histogram``,
    ``ledger_class_features`` and ``query_cell``."""
    records = _fake_records(tmp_path, card=True)
    for kw in ({}, {"classes_from": "ledger"}, {"device": "tpu_v5e"}):
        assert np.array_equal(lmf.feature_matrix(records, **kw),
                              ref_lmf.feature_matrix(records, **kw))
    assert lmf.feature_matrix([]).shape == ref_lmf.feature_matrix([]).shape
    for mod in (lmf, ref_lmf):
        with pytest.raises(ValueError, match="classes_from"):
            mod.feature_matrix(records, classes_from="nope")
    for r in records:
        assert np.array_equal(lmf.ledger_class_features(r), ref_lmf.ledger_class_features(r))
    assert np.array_equal(lmf.class_histogram({}), ref_lmf.class_histogram({}))
    for arch, stage, reduced in (("qwen3-4b", "train", None), ("mamba2-780m", "infer", False)):
        cfg, shape = lmf.query_cell(CostQuery(arch=arch, bs=3, seq=40, stage=stage,
                                              reduced=reduced))
        rcfg, rshape = ref_lmf.query_cell(ref_types.CostQuery(
            arch=arch, bs=3, seq=40, stage=stage, reduced=reduced))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        assert dataclasses.astuple(shape) == dataclasses.astuple(rshape)


# ---------------------------------------------------------------------------
# engine integration: no trace through the fitted forest
# ---------------------------------------------------------------------------


class TestTraceFreeAdmission:
    def test_admit_lm_cell_without_tracing(self, tmp_path, monkeypatch):
        records, forest = _fitted(tmp_path)
        import repro_torch.core.hlo_cost as hlo_cost
        import repro_torch.launch.lowering as lowering

        def boom(*a, **k):
            raise AssertionError("admission path traced a step")

        monkeypatch.setattr(hlo_cost, "trace_cost", boom)
        monkeypatch.setattr(lowering, "compile_cell", boom)
        monkeypatch.setattr(AnalyticalBackend, "_trace_arch", boom)
        engine = CostEngine(EnsembleBackend([ForestBackend(lm=forest), AnalyticalBackend()]))
        ok, info = engine.admit(
            CostQuery(arch="stablelm-1.6b", bs=2, seq=64, stage="train"),
            gamma_budget_mb=1e6)
        assert ok and info["source"] == "forest"
        ests = engine.backend.estimate([
            CostQuery(arch="qwen3-4b", bs=4, seq=32, stage="infer"),
            CostQuery(arch="internlm2-1.8b", bs=2, seq=16, stage="train"),
        ])
        assert all(e.source == "forest" and e.detail.get("lm") for e in ests)

    def test_unfitted_forest_falls_through(self):
        backend = ForestBackend()
        assert not backend.supports(CostQuery(arch="qwen3-4b", bs=2, stage="train"))

    def test_cache_salt_tracks_lm_forest(self, tmp_path):
        records, forest = _fitted(tmp_path)
        assert ForestBackend().cache_salt() != ForestBackend(lm=forest).cache_salt()


class TestParityAdmission:
    def test_register_and_admit_as_reference(self, tmp_path, ref_h100):
        """``register_lm_forest`` on both engines, then the same admission
        queries and budgets: the same decisions, estimates and salts."""
        records = _fake_records(tmp_path, card=True)
        mine_f = fit_lm_forest(records, holdout_frac=0.25, seed=0)
        ref_f = ref_fit.fit_lm_forest(records, holdout_frac=0.25, seed=0)
        spec = devices.get_device("h100")
        mine = CostEngine(EnsembleBackend([ForestBackend(), AnalyticalBackend(lm_device=spec)]))
        ref = ref_engine.CostEngine(ref_backends.EnsembleBackend(
            [ref_backends.ForestBackend(), ref_backends.AnalyticalBackend(
                lm_device=_ref_spec(spec))]))
        assert register_lm_forest(mine, mine_f) is mine.backend.backends[0]
        assert ref_fit.register_lm_forest(ref, ref_f) is ref.backend.backends[0]
        assert mine.backend.backends[0].cache_salt() == ref.backend.backends[0].cache_salt()
        for arch, stage, bs, seq in (("qwen3-4b", "infer", 4, 2048),
                                     ("qwen3-4b", "infer", 5, 2048),
                                     ("internlm2-1.8b", "train", 4, 2048),
                                     ("stablelm-1.6b", "train", 1, 2048)):
            kw = dict(arch=arch, bs=bs, seq=seq, stage=stage, reduced=False)
            g = mine.estimate_one(CostQuery(**kw)).gamma_mb
            for budget in (0.5 * g, 0.95 * g, 1.05 * g, 2.0 * g):
                for margin in (0.0, 0.1):
                    a = mine.admit(CostQuery(**kw), gamma_budget_mb=budget,
                                   safety_margin=margin)
                    b = ref.admit(ref_types.CostQuery(**kw), gamma_budget_mb=budget,
                                  safety_margin=margin)
                    assert a == b


# ---------------------------------------------------------------------------
# timed autotuner winners feed the calibration fit
# ---------------------------------------------------------------------------


class TestTimedWinnersCalibration:
    def _dps(self, peak, bw, n=8, seed=0):
        from repro_torch.core.dataset import Datapoint
        from repro_torch.core.features import FEATURE_NAMES
        from repro_torch.engine.decompose import latency_terms, memory_terms

        rng = np.random.default_rng(seed)
        dps = []
        for i in range(n):
            f = rng.uniform(1e3, 1e6, size=len(FEATURE_NAMES))
            flops, byts = latency_terms(f, 4)
            w, a = memory_terms(f, 4)
            dps.append(Datapoint(
                family="synthetic", level=0.1 * i, strategy="random", bs=2,
                width_mult=0.25, input_hw=16, seed=0,
                gamma_mb=float(5 + w[0] / 1e6 + a[0] / 1e6),
                phi_ms=float((flops[0] / peak + byts[0] / bw) * 1e3),
                features=[float(v) for v in f]))
        return dps

    def _timed_cache(self, tmp_path, measured_us):
        from repro_torch.kernels.autotune import TuningCache
        from repro_torch.kernels.flash_attention import tiling

        shape = tiling.shape_key((1, 2, 256, 64), (1, 2, 256, 64),
                                 causal=True, dtype="bfloat16")
        cache = TuningCache(str(tmp_path / "tuning.json"))
        cache.put("k1", {"kernel": "flash_attention", "shape": shape,
                         "config": tiling.default(shape), "source": "timed",
                         "measured_us": measured_us})
        cache.put("k2", {"kernel": "flash_attention", "shape": shape,
                         "config": tiling.default(shape), "source": "model",
                         "model_us": 1.0})
        cache.put("k3", {"kernel": "flash_attention", "source": "timed",
                         "config": {}, "measured_us": 5.0})
        return cache

    def test_fit_consumes_timed_rows(self, tmp_path):
        from repro_torch.engine.calibrate import calibrate, timed_tuning_rows

        cache = self._timed_cache(tmp_path, measured_us=500.0)
        A, phi = timed_tuning_rows(cache)
        assert A.shape == (1, 3) and phi.shape == (1,)
        assert phi[0] == pytest.approx(500e-6)
        dps = self._dps(peak=1e10, bw=1e9)
        backend = AnalyticalBackend()
        base = calibrate(backend, None, [], datapoints=dps, apply=False)
        fed = calibrate(backend, None, [], datapoints=dps, tuning_cache=cache, apply=False)
        assert base.meta["n_timed_kernel_rows"] == 0
        assert fed.meta["n_timed_kernel_rows"] == 1
        assert fed.peak_flops != pytest.approx(base.peak_flops, rel=1e-6)

    def test_empty_cache_is_noop(self, tmp_path):
        from repro_torch.engine.calibrate import timed_tuning_rows
        from repro_torch.kernels.autotune import TuningCache

        A, phi = timed_tuning_rows(TuningCache(str(tmp_path / "t.json")))
        assert len(phi) == 0


# ---------------------------------------------------------------------------
# MoE dispatch autotuning
# ---------------------------------------------------------------------------


class TestMoeDispatchTuning:
    SHAPE = dict(B=4, S=32, D=128, E=4, K=2, F=128)

    def test_capacity_formula_matches_moe_block(self):
        from repro_torch.kernels.moe_dispatch.tiling import _capacity
        from repro_torch.models.layers import moe_capacity

        for tok in (8, 17, 64, 1000):
            for E, K, f in ((4, 2, 1.25), (8, 1, 1.0), (64, 8, 2.0)):
                assert _capacity(tok, E, K, f) == moe_capacity(tok, E, K, f)

    def test_default_in_candidates_and_tuned_never_worse(self):
        from repro_torch.kernels import KernelTuner
        from repro_torch.kernels.moe_dispatch import tiling

        shape = tiling.shape_key(**self.SHAPE, capacity_factor=1.25, dtype="bfloat16")
        assert tiling.default(shape) in tiling.candidates(shape)
        entry = KernelTuner(device="tpu_v5e", measure=False).explain("moe_dispatch", shape)
        assert entry["model_us"] <= entry["default_model_us"] * (1 + 1e-9)

    def test_candidates_never_below_configured_capacity(self):
        from repro_torch.kernels.moe_dispatch import tiling

        shape = tiling.shape_key(**self.SHAPE, capacity_factor=1.5, dtype="bfloat16")
        assert all(c["capacity_factor"] >= 1.5 - 1e-9 for c in tiling.candidates(shape))

    def test_moe_block_uses_tuned_groups(self, monkeypatch):
        import repro_torch.kernels.autotune as at
        from repro_torch.models import layers

        seen = {}

        def fake_tuned(kernel, shape, default=None):
            seen["kernel"] = kernel
            return {"groups": 2, "capacity_factor": 1.0}  # below configured!

        monkeypatch.setattr(at, "tuned_config", fake_tuned)

        class Cfg:
            d_model, n_experts, experts_per_token = 128, 4, 2
            moe_d_ff_, capacity_factor = 128, 1.25

        g, f = layers._tuned_moe_dispatch(4, 32, Cfg, "bfloat16")
        assert seen["kernel"] == "moe_dispatch"
        assert g == 2
        assert f == 1.25  # clamped back up: quality knob never tightened


# ---------------------------------------------------------------------------
# the real thing: measured cells on the CPU (the card's path, device="cpu")
# ---------------------------------------------------------------------------

REF_KEYS = ("arg_mb", "collective_bytes", "compile_s", "cost_classes",
            "device_fingerprint", "energy_j", "executed", "flops", "gamma_mb",
            "hbm_bytes", "layout", "n_devices", "phi_ms", "temp_mb", "watts_proxy")


class TestCampaignSmoke:
    def test_four_cell_grid_end_to_end(self, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_AUTOTUNE", "0")
        plan = smoke_plan(archs=("qwen3-4b",),
                          shapes=("smoke_train_16x2", "smoke_train_32x2",
                                  "smoke_prefill_32x2", "smoke_prefill_64x2"))
        assert len(plan) == 4
        led = str(tmp_path / "ledger.jsonl")
        runner = CampaignRunner(plan, led, repeats=1, warmup=1, device="cpu")
        out = runner.run_campaign()
        assert out["measured"] == 4 and out["failed"] == 0
        records = runner.ledger.records("ok")
        for r in records:
            assert r["phi_ms"] > 0 and r["gamma_mb"] > 0
            assert r["flops"] > 0 and r["hbm_bytes"] > 0
            assert r["executed"] and r["n_devices"] == 1
            assert r["gamma_mb"] >= r["arg_mb"] > 0
        assert CampaignRunner(plan, led, device="cpu").run_campaign()["measured"] == 0
        forest = fit_lm_forest(records, holdout_frac=0.0, seed=0)
        engine = CostEngine(ForestBackend(lm=forest))
        ok, info = engine.admit(CostQuery(arch="qwen3-4b", bs=2, seq=16, stage="train"),
                                gamma_budget_mb=1e5)
        assert ok and info["source"] == "forest"
        r16 = next(r for r in records if r["shape"]["name"] == "smoke_train_16x2")
        est = engine.estimate_one(CostQuery(arch="qwen3-4b", bs=2, seq=16, stage="train"))
        assert est.gamma_mb == pytest.approx(r16["gamma_mb"], rel=0.75)


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_make_train_step_as_reference(monkeypatch, microbatches):
    """``launch/lowering.make_train_step`` on a reduced qwen3-4b in f32,
    the same parameters and tokens in both packages: the step's loss
    (rtol 1e-6) and the global norm of its (accumulated, f32) gradients
    before clipping (rtol 1e-5) equal the reference's for 1, 2 and 4
    microbatches, and each port step's equal the single-batch step's."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs.registry import get_config as ref_get_config
    from repro.launch import lowering as ref_lowering
    from repro.models import transformer as JT
    from repro.optim import optimizer as ref_opt
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.lowering import make_train_step
    from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state

    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    cfg, ref_cfg = get_config("qwen3-4b", reduced=True), ref_get_config("qwen3-4b", reduced=True)
    tree = JT.init_params(ref_cfg, 0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, 17)).astype(np.int32)

    def port_step(m):
        model = params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)
        model.requires_grad_(True)
        opt_cfg = OptimizerConfig()
        state = {"params": model,
                 "opt": init_opt_state(dict(model.named_parameters()), opt_cfg)}
        _, metrics = make_train_step(cfg, opt_cfg, microbatches=m)(
            state, {"tokens": torch.from_numpy(toks)})
        return float(metrics["loss"]), float(metrics["grad_norm"])

    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)), tree)
    ref_opt_cfg = ref_opt.OptimizerConfig()
    step = ref_lowering.make_train_step(ref_cfg, ref_opt_cfg, microbatches=microbatches)
    _, rm = jax.jit(step)({"params": jp, "opt": ref_opt.init_opt_state(jp, ref_opt_cfg)},
                          {"tokens": jnp.asarray(toks)})
    loss, gnorm = port_step(microbatches)
    assert loss == pytest.approx(float(rm["loss"]), rel=1e-6)
    assert gnorm == pytest.approx(float(rm["grad_norm"]), rel=1e-5)
    if microbatches > 1:
        one = port_step(1)
        assert loss == pytest.approx(one[0], rel=1e-6)
        assert gnorm == pytest.approx(one[1], rel=1e-5)


class TestParityMeasure:
    @pytest.mark.parametrize("arch, shape", [
        ("qwen3-4b", "smoke_train_16x2"),
        ("qwen3-4b", "smoke_prefill_32x2"),
        ("stablelm-1.6b", "smoke_train_16x2"),
        ("qwen3-4b", ShapeSpec("smoke_decode_32x2", 32, 2, "decode")),
    ])
    def test_measure_cell_as_reference(self, monkeypatch, arch, shape):
        """A reduced cell measured on the CPU by both packages: the
        reference's keys, the traced ledger's FLOPs equal to the
        reference's HLO count, the same ``layout`` and ``n_devices``,
        positive Γ and Φ (each package's own measurement)."""
        monkeypatch.setenv("REPRO_AUTOTUNE", "0")
        s = resolve_shape(shape)
        cell = CampaignCell(arch, s)
        ref_cell = ref_plan.CampaignCell(arch, _ref_shape(s))
        assert cell.key == ref_cell.key
        from repro_torch.campaign.runner import measure_cell

        mine = measure_cell(cell, repeats=1, warmup=1, device="cpu")
        ref = ref_runner.measure_cell(ref_cell, repeats=1, warmup=1)
        assert tuple(sorted(mine)) == tuple(sorted(ref)) == REF_KEYS
        assert mine["flops"] == ref["flops"]
        assert mine["layout"] == ref["layout"]
        assert mine["n_devices"] == ref["n_devices"] == 1
        assert mine["device_fingerprint"] == ref["device_fingerprint"]
        assert mine["gamma_mb"] >= mine["arg_mb"] > 0 and mine["phi_ms"] > 0
        assert mine["watts_proxy"] > 0 and mine["executed"]
        cls = mine["cost_classes"]
        assert sum(c["flops"] for c in cls.values()) == mine["flops"]
        unrun = measure_cell(cell, run=False, device="cpu")
        assert unrun["phi_ms"] == unrun["watts_proxy"] == 0.0 and not unrun["executed"]
        assert unrun["flops"] == mine["flops"] and unrun["gamma_mb"] > 0

    def test_multi_device_cell_quarantined(self, tmp_path):
        """A 1x2 cell on a one-device host: ``MeshSpecError`` naming the
        deficit, quarantined, and the rest of the plan still measured."""
        from repro.launch.mesh import validate_mesh_spec as ref_validate
        from repro.launch.mesh import MeshSpecError as RefMeshSpecError

        plan = plan_grid(archs=("qwen3-4b",), shapes=("smoke_prefill_32x2",),
                         meshes=("1x2", "1x1"))
        assert [c.mesh for c in plan.cells] == ["1x2", "1x1"]
        runner = CampaignRunner(plan, str(tmp_path / "l.jsonl"), repeats=1, device="cpu")
        out = runner.run_campaign()
        assert out == {"shard_cells": 2, "measured": 1, "failed": 1, "remaining": 0,
                       "ledger_records": 2}
        rec = runner.ledger.records("failed")[0]
        with pytest.raises(RefMeshSpecError) as want:
            ref_validate((1, 2), ("data", "model"), available=1)
        assert rec["error"].startswith("MeshSpecError: ")
        assert rec["error"].split(" — ")[0] == \
            "MeshSpecError: " + str(want.value).split(" — ")[0]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


class TestCli:
    def test_plan_run_status_fit(self, tmp_path, capsys, monkeypatch):
        from repro_torch.campaign import __main__ as cli

        plan_path = str(tmp_path / "plan.json")
        assert cli.main(["plan", "--smoke", "--subsample", "4", "--out", plan_path]) == 0
        load_plan(plan_path)
        led = str(tmp_path / "ledger.jsonl")
        monkeypatch.setattr("repro_torch.campaign.runner.measure_cell",
                            lambda cell, **kw: fake_measure(cell))
        assert cli.main(["run", "--plan", plan_path, "--ledger", led,
                         "--torch-device", "cpu"]) == 0
        assert cli.main(["status", "--plan", plan_path, "--ledger", led]) == 0
        assert '"pending": 0' in capsys.readouterr().out
        assert cli.main(["status", "--ledger", led, "--breakdown"]) == 0
        breakdown = json.loads(capsys.readouterr().out)["breakdown"]
        assert breakdown["records_with_breakdown"] == 4
        assert breakdown["classes"]["matmul"]["flops_share"] == 1.0
        assert 0 < breakdown["classes"]["elementwise"]["hbm_share"] < 1
        forest_path = str(tmp_path / "forest.npz")
        assert cli.main(["fit", "--ledger", led, "--out", forest_path,
                         "--holdout", "0.25"]) == 0
        assert os.path.exists(forest_path)
        assert LMForest.load(forest_path).fitted

    def test_run_refuses_without_cuda_unless_cpu(self, tmp_path, monkeypatch, capsys):
        import torch

        from repro_torch.campaign import __main__ as cli

        plan_path = str(tmp_path / "plan.json")
        cli.main(["plan", "--smoke", "--subsample", "2", "--out", plan_path])
        led = tmp_path / "ledger.jsonl"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["run", "--plan", plan_path, "--ledger", str(led)])
        assert not led.exists()
        capsys.readouterr()


def _cli_outputs(cli, tmp_path, tag, capsys, monkeypatch, measure_target):
    """Drive one package's CLI through plan → run → status → fit; return
    (plan file, ledger records, status JSON, breakdown JSON, fit meta)."""
    d = tmp_path / tag
    d.mkdir()
    plan_path, led = str(d / "plan.json"), str(d / "ledger.jsonl")
    monkeypatch.setattr(measure_target, lambda cell, **kw: fake_measure(cell))
    capsys.readouterr()
    assert cli.main(["plan", "--arch", "qwen3-4b", "--arch", "mamba2-780m",
                     "--shape", "smoke_train_16x2", "--shape", "smoke_prefill_64x4",
                     "--shape", "smoke_train_64x4", "--mesh", "2x1",
                     "--subsample", "5", "--seed", "2", "--out", plan_path]) == 0
    plan_line = capsys.readouterr().out.replace(str(d), "<dir>")
    run_argv = ["run", "--plan", plan_path, "--ledger", led]
    if tag == "port":
        run_argv += ["--torch-device", "cpu"]
    assert cli.main(run_argv + ["--max-cells", "3"]) == 3   # 3 = come back for more
    assert cli.main(run_argv) == 0
    run_out = capsys.readouterr().out
    assert cli.main(["status", "--plan", plan_path, "--ledger", led]) == 0
    status = json.loads(capsys.readouterr().out)
    assert cli.main(["status", "--ledger", led, "--breakdown"]) == 0
    breakdown = json.loads(capsys.readouterr().out)
    assert cli.main(["fit", "--ledger", led, "--out", str(d / "f.json"),
                     "--holdout", "0.25", "--seed", "1"]) == 0
    fit_out = capsys.readouterr().out
    meta = json.loads(fit_out[fit_out.index("\n") + 1:])
    return (json.load(open(plan_path)), plan_line, run_out, load_jsonl_tolerant(led),
            status, breakdown, meta)


def test_cli_outputs_as_reference(tmp_path, capsys, monkeypatch):
    """The same CLI sequence in both packages gives the same plan file,
    printed lines, ledger, status, breakdown and fitted forest meta."""
    from repro.campaign import __main__ as ref_cli
    from repro_torch.campaign import __main__ as cli

    mine = _cli_outputs(cli, tmp_path, "port", capsys, monkeypatch,
                        "repro_torch.campaign.runner.measure_cell")
    ref = _cli_outputs(ref_cli, tmp_path, "ref", capsys, monkeypatch,
                       "repro.campaign.runner.measure_cell")
    for a, b in zip(mine, ref):
        assert a == b


# ---------------------------------------------------------------------------
# the launcher's --lm-forest
# ---------------------------------------------------------------------------

_ADMIT_ARGV = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "1", "--batch", "2",
               "--seq", "16"]


@pytest.mark.parametrize("flags, admits", [
    (["--memory-budget-gb", "0.001"], False),
    (["--memory-budget-gb", "100"], True),
    (["--energy-budget-j", "1e-9"], False),
    ([], True),
])
def test_launcher_lm_forest_as_reference(tmp_path, monkeypatch, capsys, flags, admits, ref_h100):
    """``--lm-forest`` (a forest the port fitted and saved, loaded by both
    launchers) admits or refuses a reduced cell as the reference's
    launcher does, from the forest alone: no trace, no parameter drawn."""
    import sys

    from repro.launch import train as ref_launch
    from repro.train import trainer as ref_trainer
    from repro_torch.launch import train as launch
    from repro_torch.models import transformer as T
    from repro_torch.serve import PlacementRefused
    from repro_torch.train import trainer as port_trainer

    records = _fake_records(tmp_path, card=True)
    path = str(tmp_path / "forest.npz")
    port_fit.fit_lm_forest(records, holdout_frac=0.25, seed=0).save(path)
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    empty = lambda self, n: {"history": [], "stragglers": []}  # noqa: E731
    monkeypatch.setattr(ref_trainer.Trainer, "train", empty)
    monkeypatch.setattr(port_trainer.Trainer, "train", empty)
    draws = []
    monkeypatch.setattr(T, "init_params", lambda *a, **k: draws.append(1))

    def boom(*a, **k):
        raise AssertionError("the forest did not answer")

    monkeypatch.setattr(AnalyticalBackend, "_trace_arch", boom)
    argv = _ADMIT_ARGV + ["--lm-forest", path] + flags
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    try:
        ref_launch.main()
        ref_admits = True
    except RuntimeError as e:
        assert "admission denied" in str(e)
        ref_admits = False
    try:
        launch.main(argv + ["--torch-device", "cpu"])
        port_admits = True
    except PlacementRefused as e:
        assert e.info["source"] == "forest"
        port_admits = False
    capsys.readouterr()
    assert port_admits == ref_admits == admits and not draws
