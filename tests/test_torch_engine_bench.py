"""The port's engine benchmark (``repro_torch.bench.engine_bench``) against
the reference's (``benchmarks/engine_bench.py``) on the CPU.

* ``run``: the forest backend's batched estimates for the 100-candidate
  population equal the reference's, value for value, and so does the
  batched-against-scalar deviation (``max_dev``: both packages' packed
  forest sums in another order than the scalar walk, 2.8e-14 in both);
  the CSV names are the reference's.  Timing rows are not gated here.
* the golden program's ledger (8 chained ``tanh(c @ w)`` and the gradient
  with respect to the input): class sums re-sum to the scalars, and the
  product FLOPs equal the reference's HLO count within 1e-9.
* ``calibration_accuracy`` over the read-only fixture: every row equals
  the reference's within rel 1e-9, and the fixture is not written.
* ``campaign_accuracy`` on a copy of a ledger the reference measured:
  nothing newly measured, and the forest and fitted-constant rows equal
  the reference's (the analytical rows are each package's own estimator:
  an XLA compile there, a meta-tensor trace here).  The reference's
  campaign needs at least 6 recorded cells to fit, so the ledger holds
  its smoke plan at ``subsample=8`` (4 cells would skip the fit in both).
* ``collective_calibration``: the reference's >1-device smoke grid over
  two ``gloo`` CPU ranks, the reference's rows and keys, the multi-device
  cells with collective bytes and the 1x1 ones with none; a second call
  resumes (measures nothing) and fits again.
"""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

from benchmarks import engine_bench as ref_bench
from repro_torch.bench import engine_bench
from tests._torch_host import port_host_share  # noqa: F401 (autouse)


def _rows(lines):
    """name -> (value, derived) of CSV lines."""
    out = {}
    for ln in lines:
        name, value, derived = ln.split(",", 2)
        out[name] = (float(value), derived)
    return out


@pytest.fixture(scope="module")
def runs():
    fixture = engine_bench.PROFILE_CACHE
    before = hashlib.sha1(open(fixture, "rb").read()).hexdigest()
    mine, ref = [], []
    out = engine_bench.run(mine.append, device="cpu")
    ref_out = ref_bench.run(ref.append)
    after = hashlib.sha1(open(fixture, "rb").read()).hexdigest()
    return out, mine, ref_out, ref, before == after


def test_run_estimates_equal_the_reference(runs):
    from repro.core.search import sample_subnetwork as ref_sample
    from repro.engine import CostQuery as RefQuery
    from repro.engine import ForestBackend as RefForest
    from repro.models.cnn import build_resnet50 as ref_resnet

    out, mine, ref_out, ref, _ = runs
    predictor = ref_bench._fitted_predictor()
    base = ref_resnet(width_mult=ref_bench.WM, input_hw=ref_bench.HW)
    rng = np.random.default_rng(1)
    specs = [ref_resnet(widths=ref_sample(base.widths, rng),
                        input_hw=ref_bench.HW).conv_specs()
             for _ in range(ref_bench.POPULATION)]
    ests = RefForest(train=predictor).estimate(
        [RefQuery(spec=s, bs=ref_bench.BS, stage="train") for s in specs])
    assert out["estimates"] == [(e.gamma_mb, e.phi_ms) for e in ests]
    assert out["max_dev"] == ref_out["max_dev"] <= 1e-9
    assert [ln.split(",")[0] for ln in mine] == [ln.split(",")[0] for ln in ref]
    assert _rows(mine)["engine/cached_ms_per_100"][1] == "hits=100"


def test_ledger_parity_and_golden_flops(runs):
    import jax
    import jax.numpy as jnp

    from repro.core.hlo_cost import parse_hlo_cost
    from repro_torch.core.hlo_cost import trace_cost

    out, mine, ref_out, _, _ = runs
    assert out["ledger_parity_dev"] == 0.0
    assert out["ledger_energy_parity_dev"] <= 1e-9

    def f(x, ws):
        return jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0].sum()

    ref = parse_hlo_cost(jax.jit(jax.grad(f)).lower(
        jnp.zeros((64, 64)), jnp.zeros((8, 64, 64))).compile().as_text())
    x = torch.empty(64, 64, device="meta", requires_grad=True)
    cost = trace_cost(engine_bench.golden_step, x, torch.empty(8, 64, 64, device="meta"))
    mm = cost.by_class()["matmul"]["flops"]
    assert mm == out["ledger_flops"] == 16 * 2 * 64 ** 3
    assert mm == pytest.approx(ref.by_class()["matmul"]["flops"], rel=1e-9)
    assert _rows(mine)["engine/ledger_breakdown_parity_dev"][1].endswith(
        "matmul_flops_share=1.00")


def test_calibration_rows_equal_the_reference(runs):
    out, mine, ref_out, ref, fixture_unchanged = runs
    assert fixture_unchanged
    keys = [k for k in ref_out if "mape" in k]
    assert len(keys) >= 6 and set(keys) <= set(out)
    for k in keys:
        assert out[k] == pytest.approx(ref_out[k], rel=1e-9, abs=0), k
    mine_rows, ref_rows = _rows(mine), _rows(ref)
    for name in ref_rows:
        if "mape" in name:
            assert mine_rows[name][1] == ref_rows[name][1], name
            assert mine_rows[name][0] == pytest.approx(ref_rows[name][0], rel=1e-9)


def test_calibration_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine_bench.calibration_accuracy(lambda *_: None)


def test_campaign_rows_on_a_ledger_the_reference_measured(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    ref_lines, mine_lines = [], []
    ref_ledger = str(tmp_path / "ref.jsonl")
    ref = ref_bench.campaign_accuracy(ref_lines.append, ledger_path=ref_ledger,
                                      subsample=8)
    port_ledger = str(tmp_path / "port.jsonl")
    shutil.copy(ref_ledger, port_ledger)
    mine = engine_bench.campaign_accuracy(mine_lines.append, ledger_path=port_ledger,
                                          subsample=8, device="cpu")
    assert mine["measured"] == 0
    assert os.path.getsize(port_ledger) == os.path.getsize(ref_ledger)
    for k in ("forest_phi_mape", "forest_gamma_mape", "forest_energy_mape",
              "n_heldout", "breakdown_parity_dev", "hlo_phi_mape_applied",
              "hlo_phi_mape_aggregate", "hlo_energy_mape_applied",
              "hlo_energy_mape_aggregate"):
        assert mine[k] == ref[k], k
    assert mine["analytical_phi_mape"] > 0 and mine["analytical_gamma_mape"] >= 0
    ref_rows, mine_rows = _rows(ref_lines), _rows(mine_lines)
    assert list(mine_rows) == list(ref_rows)
    for name, (value, derived) in ref_rows.items():
        if "analytical" in name or name == "campaign/cells_measured":
            continue
        assert mine_rows[name] == (value, derived), name
    assert mine_rows["campaign/cells_measured"][0] == 0


def test_campaign_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine_bench.campaign_accuracy(ledger_path=str(tmp_path / "l.jsonl"))


def test_collective_calibration_names_item_7c(tmp_path):
    from repro_torch.campaign import CampaignLedger

    ledger = str(tmp_path / "collective.jsonl")
    lines = []
    out = engine_bench.collective_calibration(lines.append, ledger_path=ledger)
    assert set(out) == {"collective_cells", "collective_column_fitted",
                        "collective_coeff", "collective_coeff_aggregate", "n_records"}
    assert out["n_records"] == 6 and out["collective_cells"] == 4
    assert out["collective_column_fitted"] and out["collective_coeff"] >= 0
    assert [ln.split(",")[0] for ln in lines] == [
        "campaign/collective_cells", "campaign/collective_column_fitted",
        "campaign/collective_coeff_s_per_byte"]
    recs = CampaignLedger(ledger).records("ok")
    assert len(recs) == 6 and all(r["phi_ms"] > 0 for r in recs)
    for r in recs:
        assert r["n_devices"] == (1 if r["mesh"] == "1x1" else 2)
        assert (r["collective_bytes"] > 0) == (r["mesh"] != "1x1")
    again = engine_bench.collective_calibration(lambda _: None, ledger_path=ledger)
    assert len(CampaignLedger(ledger).records()) == 6
    assert again["n_records"] == 6 and again["collective_cells"] == 4
