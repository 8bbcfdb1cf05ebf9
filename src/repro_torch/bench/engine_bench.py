"""Engine benchmark (port of ``benchmarks/engine_bench.py``): batched
``CostBackend.estimate`` against per-candidate scalar prediction on a
search-shaped workload, the on-disk estimate cache's hit path, the cost
ledger's class-sum parity, the analytical backend's accuracy before and
after calibration, the campaign forest's accuracy, and the planner's
pricing rows.  The reference's CSV names, through ``common.csv_line``.

    PYTHONPATH=src python -m repro_torch.bench.engine_bench

Where the reference differs from a torch port:

* ``ledger_breakdown_parity`` traces the reference's golden program — 8
  chained ``tanh(c @ w)`` on 64×64 and its gradient with respect to the
  input — with the port's ``core.hlo_cost.trace_cost`` on meta tensors,
  where the reference parses XLA's compiled HLO;
* ``calibration_accuracy`` reads ``benchmarks/cache/cnn_profile.json``
  read-only, as the reference does: its targets were measured on a host
  CPU by the reference, so its MAPEs are not the card's.  Its
  ``ProfilerBackend`` takes ``device`` (default ``"cuda"``; it raises
  without a card unless given ``"cpu"``) and profiles nothing;
* ``campaign_accuracy`` runs the reference's ``smoke_plan`` through the
  port's ``CampaignRunner`` on the runner's ``device``, into a ledger the
  caller names (default under ``build/repro_torch/``);
* ``planner_bench`` traps the port's counterpart of the reference's
  ``_compile_arch``, ``AnalyticalBackend._trace_arch``, and counts its
  calls;
* ``collective_calibration`` measures the reference's >1-device grid
  (``campaign.plan.collective_smoke_plan``) over two ``gloo`` CPU ranks
  in a subprocess, where the reference forces two host devices: both
  measure collectives on the host.
"""

from __future__ import annotations

import os
import time

import numpy as np

from repro_torch.bench.common import csv_line
from repro_torch.core.dataset import Datapoint, DatasetCache
from repro_torch.core.features import network_features
from repro_torch.core.predictor import Perf4Sight
from repro_torch.core.search import sample_subnetwork
from repro_torch.device import resolve_device as resolve_torch_device
from repro_torch.engine import (
    AnalyticalBackend,
    CostEngine,
    CostQuery,
    EstimateCache,
    ForestBackend,
    ProfilerBackend,
    calibrate,
    default_workloads,
    evaluate_accuracy,
)
from repro_torch.kernels.build import BUILD_DIR
from repro_torch.models.cnn import build_resnet50

__all__ = ["PROFILE_CACHE", "POPULATION", "run", "ledger_breakdown_parity",
           "calibration_accuracy", "campaign_accuracy", "planner_bench",
           "collective_calibration"]

# the reference's host-measured fixture, read and never written
PROFILE_CACHE = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                             "benchmarks", "cache", "cnn_profile.json")
ESTIMATE_CACHE = str(BUILD_DIR / "engine_bench_cache.json")
CAMPAIGN_LEDGER = str(BUILD_DIR / "engine_bench_campaign_smoke.jsonl")

POPULATION = 100
BS = 16
WM, HW = 0.25, 16


def _fitted_predictor(n_points: int = 60, seed: int = 0) -> Perf4Sight:
    """Fit on synthetic feature-driven targets (no profiling needed — this
    bench measures prediction throughput, not accuracy)."""
    from repro_torch.core.pruning import pruned_model

    rng = np.random.default_rng(seed)
    dps = []
    for _ in range(n_points):
        level = float(rng.uniform(0, 0.9))
        bs = int(rng.integers(2, 33))
        m = pruned_model("resnet50", level, "uniform", seed=0,
                         width_mult=WM, input_hw=HW)
        f = network_features(m.conv_specs(), bs)
        dps.append(Datapoint(
            family="resnet50", level=level, strategy="uniform", bs=bs,
            width_mult=WM, input_hw=HW, seed=0,
            gamma_mb=5.0 + f[4] / 1e5, phi_ms=2.0 + f[14] / 1e7,
            features=[float(v) for v in f]))
    return Perf4Sight(n_estimators=100).fit(dps)


def run(print_fn=print, population: int = POPULATION, repeats: int = 3, *,
        device="cuda") -> dict:
    """The reference's ``run``: timing and parity rows of the forest
    backend, then :func:`ledger_breakdown_parity` and
    :func:`calibration_accuracy` (on ``device``)."""
    resolve_torch_device(device)          # no card: raise before any work
    predictor = _fitted_predictor()
    base = build_resnet50(width_mult=WM, input_hw=HW)
    rng = np.random.default_rng(1)
    specs = [
        build_resnet50(widths=sample_subnetwork(base.widths, rng),
                       input_hw=HW).conv_specs()
        for _ in range(population)
    ]
    queries = [CostQuery(spec=s, bs=BS, stage="train") for s in specs]
    backend = ForestBackend(train=predictor)

    # warm both paths (forest packing, numpy dispatch)
    backend.estimate(queries[:2])
    predictor.predict(specs[0], BS)

    t_batch = min(
        _timed(lambda: backend.estimate(queries)) for _ in range(repeats))
    t_scalar = min(
        _timed(lambda: [predictor.predict(s, BS) for s in specs])
        for _ in range(repeats))
    speedup = t_scalar / t_batch

    # parity: the batched path must agree with the scalar path exactly
    ests = backend.estimate(queries)
    scalar = [predictor.predict(s, BS) for s in specs]
    max_dev = max(
        max(abs(e.gamma_mb - g), abs(e.phi_ms - p))
        for e, (g, p) in zip(ests, scalar))

    # cache path: second visit to the same population is pure dict lookups
    if os.path.exists(ESTIMATE_CACHE):
        os.unlink(ESTIMATE_CACHE)
    engine = CostEngine(backend, cache=EstimateCache(ESTIMATE_CACHE))
    engine.estimate(queries)
    t_cached = _timed(lambda: engine.estimate(queries))

    print_fn(csv_line("engine/scalar_ms_per_100", t_scalar * 1e3,
                      f"pop={population}"))
    print_fn(csv_line("engine/batched_ms_per_100", t_batch * 1e3,
                      f"speedup={speedup:.1f}x"))
    print_fn(csv_line("engine/cached_ms_per_100", t_cached * 1e3,
                      f"hits={engine.hits}"))
    print_fn(csv_line("engine/parity_max_abs_dev", max_dev, "expect=0"))
    ledger = ledger_breakdown_parity(print_fn)
    accuracy = calibration_accuracy(print_fn, device=device)
    return {"speedup": speedup, "t_scalar_s": t_scalar, "t_batch_s": t_batch,
            "t_cached_s": t_cached, "max_dev": max_dev,
            "estimates": [(e.gamma_mb, e.phi_ms) for e in ests],
            **ledger, **accuracy}


def golden_step(x, ws):
    """The reference's golden program (``benchmarks/engine_bench.py:138-144``):
    8 chained ``tanh(c @ w)`` and the gradient of their sum with respect to
    the input ``x``."""
    import torch

    c = x
    for w in ws:
        c = torch.tanh(c @ w)
    return torch.autograd.grad(c.sum(), x)


def ledger_breakdown_parity(print_fn=print) -> dict:
    """Cost-ledger parity on the golden program: the per-op ledger's class
    sums must reproduce the ``HloCost`` scalars.  Reported as a RELATIVE
    deviation (the class-grouped re-sum associates float additions
    differently).  A meta-tensor trace: nothing allocated or launched."""
    import torch

    from repro_torch.core.hlo_cost import trace_cost
    from repro_torch.engine import get_device
    from repro_torch.engine.decompose import price_ledger_energy

    x = torch.empty(64, 64, device="meta", requires_grad=True)
    ws = torch.empty(8, 64, 64, device="meta")
    cost = trace_cost(golden_step, x, ws)
    sums = cost.by_class()
    dev = max(
        abs(sum(s["flops"] for s in sums.values()) - cost.flops)
        / max(abs(cost.flops), 1.0),
        abs(sum(s["hbm_bytes"] for s in sums.values()) - cost.hbm_bytes)
        / max(abs(cost.hbm_bytes), 1.0),
        abs(sum(s["collective_bytes"] for s in sums.values())
            - cost.collective_bytes) / max(abs(cost.collective_bytes), 1.0),
    )
    matmul_share = (sums.get("matmul", {}).get("flops", 0.0)
                    / cost.flops if cost.flops else 0.0)
    print_fn(csv_line("engine/ledger_breakdown_parity_dev", dev,
                      f"relative expect=0 records={len(cost.ledger)} "
                      f"matmul_flops_share={matmul_share:.2f}"))
    # energy parity: the same ledger priced under a power envelope; the
    # per-class joule sums must reproduce the ledger aggregate
    eled = price_ledger_energy(cost.ledger, get_device("tx2_like"))
    esums = eled.class_sums()
    edev = (abs(sum(s["energy_j"] for s in esums.values()) - eled.energy_j)
            / max(abs(eled.energy_j), 1e-30))
    print_fn(csv_line("engine/ledger_energy_parity_dev", edev,
                      f"relative expect=0 total={eled.energy_j:.3g}J"))
    return {"ledger_parity_dev": dev, "ledger_energy_parity_dev": edev,
            "ledger_flops": cost.flops}


def calibration_accuracy(print_fn=print, *, device="cuda") -> dict:
    """AnalyticalBackend prediction error against the profiler's ground
    truth, before and after calibration, over the reference's fixture.

    Strictly read-only on the fixture: workloads missing from it are
    skipped, never profiled.  The fixture's targets were measured on a host
    CPU, so these MAPEs are the fixture's, not ``device``'s."""
    profiler = ProfilerBackend(repeats=1, warmup=0, device=device)
    if not os.path.exists(PROFILE_CACHE):
        print_fn(csv_line("engine/calibration_skipped", 1.0, "no cache"))
        return {}
    cache = DatasetCache(PROFILE_CACHE)
    dps = [cache.get(w.key) for w in default_workloads()]
    missing = sum(d is None for d in dps)
    dps = [d for d in dps if d is not None]
    if missing:
        print_fn(csv_line("engine/calibration_workloads_missing", missing,
                          "fixture stale; skipped, not re-profiled"))
    if len(dps) < 3:
        print_fn(csv_line("engine/calibration_skipped", 1.0,
                          "fixture too sparse"))
        return {}
    backend = AnalyticalBackend()
    before = evaluate_accuracy(backend, dps)
    spec = calibrate(backend, profiler, [], datapoints=dps)
    after = evaluate_accuracy(backend, dps)
    print_fn(csv_line("engine/phi_mape_uncalibrated", before["phi_mape"],
                      f"device={spec.meta['base_device']}"))
    print_fn(csv_line("engine/phi_mape_calibrated", after["phi_mape"],
                      f"device={spec.name} fit={spec.meta['latency_fit']}"))
    # class-wise vs aggregate attribution rows: the applied fit is whichever
    # MAPE is lower
    print_fn(csv_line("engine/phi_mape_cal_aggregate",
                      spec.meta["phi_mape_aggregate"], "3-term fallback"))
    print_fn(csv_line("engine/phi_mape_cal_classwise",
                      spec.meta["phi_mape_classwise"],
                      "per-op-class columns"))
    print_fn(csv_line("engine/gamma_mape_uncalibrated", before["gamma_mape"],
                      f"n={before['n']}"))
    print_fn(csv_line("engine/gamma_mape_calibrated", after["gamma_mape"],
                      "target<=0.10"))
    out = {"phi_mape_uncal": before["phi_mape"],
           "phi_mape_cal": after["phi_mape"],
           "phi_mape_cal_aggregate": spec.meta["phi_mape_aggregate"],
           "phi_mape_cal_classwise": spec.meta["phi_mape_classwise"],
           "gamma_mape_uncal": before["gamma_mape"],
           "gamma_mape_cal": after["gamma_mape"]}
    # energy fit accuracy: the fixture predates energy measurement, so its
    # targets are the watts-proxy integral (energy_proxied says how many)
    if spec.meta.get("energy_fit", "none") != "none":
        print_fn(csv_line("engine/energy_mape_cal_aggregate",
                          spec.meta["energy_mape_aggregate"],
                          f"proxied={spec.meta['energy_proxied']}"))
        print_fn(csv_line("engine/energy_mape_cal_classwise",
                          spec.meta["energy_mape_classwise"],
                          f"fit={spec.meta['energy_fit']}"))
        out["energy_mape_cal"] = spec.meta["energy_mape"]
        out["energy_mape_cal_aggregate"] = spec.meta["energy_mape_aggregate"]
    return out


def campaign_accuracy(print_fn=print, *, ledger_path: str | None = None,
                      subsample: int | None = None, device="cuda") -> dict:
    """LM-forest accuracy rows: run (or resume) the reference's smoke
    campaign on ``device``, fit the forest, and compare held-out-cell MAPE
    against the uncalibrated analytical path (a meta-tensor trace per cell;
    the forest traces nothing).  The ledger persists across runs, so a
    second run measures nothing new."""
    from repro_torch.campaign import (
        CampaignRunner,
        fit_lm_forest,
        smoke_plan,
    )
    from repro_torch.core.predictor import mape
    from repro_torch.engine.types import STAGE_INFER, STAGE_TRAIN

    ledger_path = ledger_path or CAMPAIGN_LEDGER
    os.makedirs(os.path.dirname(os.path.abspath(ledger_path)), exist_ok=True)
    plan = smoke_plan(subsample=subsample)
    runner = CampaignRunner(plan, ledger_path, repeats=2, warmup=1,
                            device=device)
    summary = runner.run_campaign(print_fn=lambda *_: None)
    print_fn(csv_line("campaign/cells_measured", summary["measured"],
                      f"grid={len(plan)} quarantined={summary['failed']}"))

    # membership by cell key, not plan_hash: records of an earlier plan
    # revision whose cells still overlap this one are valid measurements
    plan_keys = {c.key for c in plan.cells}
    records = [r for r in runner.ledger.records("ok")
               if r.get("key") in plan_keys]
    if len(records) < 6:
        print_fn(csv_line("campaign/skipped", 1.0, "grid too sparse"))
        return {"measured": summary["measured"]}
    try:
        forest = fit_lm_forest(records, holdout_frac=0.25, seed=0)
    except ValueError as e:
        # a stale persisted ledger (fingerprint drift) skips, as in the
        # reference; deleting the ledger re-measures from scratch
        print_fn(csv_line("campaign/skipped", 1.0, f"fit refused: {e}"))
        return {"measured": summary["measured"]}
    meta = forest.meta

    # cost-ledger rows: per-record breakdown parity + class-wise vs
    # aggregate constant-fit MAPE
    with_classes = [r for r in records if r.get("cost_classes")]
    extra = {}
    if with_classes:
        def rel_dev(rec, key):
            total = sum(s.get(key, 0.0) for s in rec["cost_classes"].values())
            return abs(total - rec[key]) / max(abs(rec[key]), 1.0)

        parity_dev = max(
            max(rel_dev(r, k) for k in ("flops", "hbm_bytes",
                                        "collective_bytes"))
            for r in with_classes)
        print_fn(csv_line("campaign/breakdown_parity_dev", parity_dev,
                          f"relative expect=0 n={len(with_classes)}"))
        extra["breakdown_parity_dev"] = parity_dev
        from repro_torch.campaign import fit_hlo_constants

        try:
            spec = fit_hlo_constants(with_classes)
        except ValueError as e:
            print_fn(csv_line("campaign/hlo_fit_skipped", 1.0, str(e)))
            spec = None
        if spec is not None:
            print_fn(csv_line("campaign/hlo_phi_mape_aggregate",
                              spec.meta["phi_mape_aggregate"],
                              "4-term fallback"))
            if spec.meta["phi_mape_classwise"] is not None:
                print_fn(csv_line("campaign/hlo_phi_mape_classwise",
                                  spec.meta["phi_mape_classwise"],
                                  f"fit={spec.meta['latency_fit']}"))
            # the applied fit re-priced through the analytical backend's
            # own decompose paths: an independent recomputation
            from repro_torch.engine.decompose import (
                classwise_seconds,
                ledger_latency_columns,
                lm_roofline_terms,
            )

            executed = [r for r in with_classes if r.get("phi_ms", 0) > 0]
            phi_true = np.array([r["phi_ms"] for r in executed]) / 1e3
            coeffs = spec.class_coeffs.get("lm_latency")
            if coeffs:
                pred = classwise_seconds(ledger_latency_columns(
                    [r["cost_classes"] for r in executed]), coeffs)
            else:
                terms = lm_roofline_terms(
                    np.array([r["flops"] for r in executed]),
                    np.array([r["hbm_bytes"] for r in executed]),
                    np.array([r["collective_bytes"] for r in executed]),
                    spec)
                pred = spec.launch_overhead_s + sum(terms)
            applied = float(mape(np.asarray(pred), phi_true))
            print_fn(csv_line("campaign/hlo_phi_mape_applied", applied,
                              f"fit={spec.meta['latency_fit']} re-priced"))
            extra["hlo_phi_mape_applied"] = applied
            extra["hlo_phi_mape_aggregate"] = spec.meta["phi_mape_aggregate"]
            if spec.meta.get("energy_fit", "none") != "none":
                print_fn(csv_line("campaign/hlo_energy_mape_aggregate",
                                  spec.meta["energy_mape_aggregate"],
                                  "tied fallback"))
                print_fn(csv_line("campaign/hlo_energy_mape_applied",
                                  spec.meta["energy_mape"],
                                  f"fit={spec.meta['energy_fit']}"))
                extra["hlo_energy_mape_applied"] = spec.meta["energy_mape"]
                extra["hlo_energy_mape_aggregate"] = \
                    spec.meta["energy_mape_aggregate"]

    # held-out cells through both paths (the fit's split seed: the forest
    # has never seen them)
    from repro_torch.campaign.fit import split_records

    _, heldout = split_records(records, holdout_frac=0.25, seed=0)
    queries = [
        CostQuery(arch=r["arch"], bs=r["shape"]["global_batch"],
                  seq=r["shape"]["seq_len"],
                  stage=STAGE_TRAIN if r["shape"]["kind"] == "train"
                  else STAGE_INFER,
                  reduced=True)
        for r in heldout
    ]
    analytical = AnalyticalBackend(reduced=True, lm_device="host_cpu")
    ests = analytical.estimate(queries)
    phi_true = np.array([r["phi_ms"] for r in heldout])
    gamma_true = np.array([r["gamma_mb"] for r in heldout])
    anal_phi = mape(np.array([e.phi_ms for e in ests]), phi_true)
    anal_gamma = mape(np.array([e.gamma_mb for e in ests]), gamma_true)
    out = {
        "measured": summary["measured"],
        "forest_phi_mape": meta["holdout_phi_mape"],
        "forest_gamma_mape": meta["holdout_gamma_mape"],
        "analytical_phi_mape": anal_phi,
        "analytical_gamma_mape": anal_gamma,
        "n_heldout": len(heldout),
        **extra,
    }
    print_fn(csv_line("campaign/phi_mape_forest", out["forest_phi_mape"],
                      f"heldout={len(heldout)} zero-compile"))
    print_fn(csv_line("campaign/phi_mape_analytical", anal_phi,
                      "meta trace per cell"))
    print_fn(csv_line("campaign/gamma_mape_forest", out["forest_gamma_mape"],
                      ""))
    print_fn(csv_line("campaign/gamma_mape_analytical", anal_gamma, ""))
    if meta.get("holdout_energy_mape") is not None:
        print_fn(csv_line("campaign/energy_mape_forest",
                          meta["holdout_energy_mape"], "zero-compile"))
        out["forest_energy_mape"] = meta["holdout_energy_mape"]
    return out


class _PlantedLMForest:
    """Fitted-forest stand-in: constant (Γ, Φ) for every query."""

    fitted = True
    meta: dict = {}

    def __init__(self, gamma_mb, phi_ms):
        from repro_torch.engine import get_device

        self.gamma_mb, self.phi_ms = gamma_mb, phi_ms
        self.default_device = get_device("tpu_v5e")

    def content_hash(self):
        return f"planted-{self.gamma_mb}-{self.phi_ms}"

    def predict_queries(self, queries):
        n = len(queries)
        return (np.full(n, self.gamma_mb), np.full(n, self.phi_ms))


def planner_bench(print_fn=print, *, n_devices: int = 256) -> dict:
    """Auto-sharding planner rows: the size of the layout space, the wall
    clock to price all of it through the engine, and the predicted speedup
    of the chosen layout over the reference's production mesh (1x16x16),
    with the analytical backend's trace trapped for the whole run, so the
    zero-trace guarantee is counted, not assumed.  The base query is
    answered by a planted forest (known Γ/Φ) under ``tpu_v5e``'s spec, as
    in the reference: the rows are deterministic and framework-free."""
    from repro_torch.engine import EnsembleBackend, get_device
    from repro_torch.planner import LayoutPlanner

    traces = {"n": 0}
    orig = AnalyticalBackend._trace_arch

    def boom(*a, **k):
        traces["n"] += 1
        raise AssertionError("planner pricing traced a step")

    AnalyticalBackend._trace_arch = boom
    try:
        engine = CostEngine(
            EnsembleBackend([
                ForestBackend(lm=_PlantedLMForest(40_000.0, 1000.0)),
                AnalyticalBackend(),
            ]),
            device=get_device("tpu_v5e"))
        planner = LayoutPlanner(engine)
        t0 = time.perf_counter()
        plan = planner.plan("qwen3-4b", "train_4k", n_devices, n_micro=8)
        wall_s = time.perf_counter() - t0
    finally:
        AnalyticalBackend._trace_arch = orig

    chosen = plan.chosen
    default = plan.decision_for("1x16x16") if n_devices == 256 else None
    speedup = (default.phi_ms / chosen.phi_ms
               if (chosen and default) else float("nan"))
    print_fn(csv_line("planner/layouts_enumerated", plan.meta["n_layouts"],
                      f"devices={n_devices} ranked={plan.meta['n_ranked']} "
                      f"refused={plan.meta['n_refused']}"))
    print_fn(csv_line("planner/pricing_wall_ms", wall_s * 1e3,
                      f"target<1000 compiles={traces['n']}"))
    if chosen and default:
        print_fn(csv_line("planner/chosen_vs_default_speedup", speedup,
                          f"chosen={chosen.layout.descriptor} "
                          f"phi={chosen.phi_ms:.2f}ms vs 1x16x16 "
                          f"{default.phi_ms:.2f}ms"))
    return {
        "layouts": plan.meta["n_layouts"],
        "wall_s": wall_s,
        "compiles": traces["n"],
        "chosen": chosen.layout.descriptor if chosen else None,
        "chosen_phi_ms": chosen.phi_ms if chosen else float("inf"),
        "default_phi_ms": default.phi_ms if default else float("nan"),
        "speedup": speedup,
    }


COLLECTIVE_LEDGER = str(BUILD_DIR / "engine_bench_campaign_collective.jsonl")

def _collective_rank(rank: int, store: str, ledger: str) -> None:
    """One of the two ``gloo`` ranks of :func:`collective_calibration`:
    the >1-device smoke grid through the campaign runner (every rank runs
    every cell; rank 0 writes the ledger)."""
    import torch
    import torch.distributed as dist

    from repro_torch.campaign import CampaignRunner
    from repro_torch.campaign.plan import collective_smoke_plan

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=2)
    try:
        out = CampaignRunner(collective_smoke_plan(), ledger, repeats=2, warmup=1,
                             device="cpu").run_campaign()
        if rank == 0:
            print("CELLS", out["measured"], out["failed"], out["remaining"], flush=True)
    finally:
        dist.destroy_process_group()


def _collective_main(store: str, ledger: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_collective_rank, args=(store, ledger), nprocs=2)


_COLLECTIVE_SCRIPT = ("import sys\n"
                      "from repro_torch.bench.engine_bench import _collective_main\n"
                      "_collective_main(sys.argv[1], sys.argv[2])\n")


def collective_calibration(print_fn=print, *, ledger_path: str | None = None
                           ) -> dict:
    """Collective-coefficient rows: run the >1-device calibration grid
    (``campaign.plan.collective_smoke_plan`` — the same cells on 1x1,
    2x1 and 1x2 meshes) over two ``gloo`` CPU ranks in a subprocess, then
    fit the HLO constants over the ledger and report whether the
    collective column entered the fit on real measurements.

    Subprocess because the two ranks are processes of their own (the
    reference's: a forced 2-device host, which must be set before jax
    initializes).  The ledger (default under ``build/repro_torch/``)
    persists, so after the first run this is resume + fit.  Skips (empty
    dict) instead of failing when the subprocess or the fit can't run —
    the reference's degraded contract."""
    import json
    import shutil
    import subprocess
    import sys
    import tempfile

    from repro_torch.campaign import CampaignLedger, fit_hlo_constants
    from repro_torch.campaign.plan import collective_smoke_plan

    ledger_path = ledger_path or COLLECTIVE_LEDGER
    os.makedirs(os.path.dirname(os.path.abspath(ledger_path)), exist_ok=True)
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    store_dir = tempfile.mkdtemp(prefix="collective_store_", dir=str(BUILD_DIR))
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _COLLECTIVE_SCRIPT,
             os.path.join(store_dir, "store"), os.path.abspath(ledger_path)],
            env=env, capture_output=True, text=True, timeout=900)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    if proc.returncode != 0:
        print_fn(csv_line("campaign/collective_skipped", 1.0,
                          f"measure subprocess failed: "
                          f"{proc.stderr.strip().splitlines()[-1:] or '?'}"))
        return {}

    plan_keys = {c.key for c in collective_smoke_plan().cells}
    records = [r for r in CampaignLedger(ledger_path).records("ok")
               if r.get("key") in plan_keys]
    try:
        spec = fit_hlo_constants(records)
    except ValueError as e:
        print_fn(csv_line("campaign/collective_skipped", 1.0,
                          f"fit refused: {e}"))
        return {}
    meta = spec.meta
    coeff = (meta["collective_coeff_classwise"]
             if meta["collective_coeff_classwise"] is not None
             else meta["collective_coeff_aggregate"])
    print_fn(csv_line("campaign/collective_cells", meta["collective_cells"],
                      f"of {len(records)} fitted (meshes 1x1/2x1/1x2)"))
    print_fn(csv_line("campaign/collective_column_fitted",
                      float(meta["collective_column_fitted"]),
                      f"classwise_columns={len(meta['classwise_columns'])}"))
    print_fn(csv_line("campaign/collective_coeff_s_per_byte", coeff,
                      json.dumps({"aggregate":
                                  meta["collective_coeff_aggregate"]})))
    return {
        "collective_cells": meta["collective_cells"],
        "collective_column_fitted": meta["collective_column_fitted"],
        "collective_coeff": coeff,
        "collective_coeff_aggregate": meta["collective_coeff_aggregate"],
        "n_records": len(records),
    }


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


if __name__ == "__main__":
    out = run()
    planner_bench()
    print(f"\nbatched speedup: {out['speedup']:.1f}x "
          f"(target >=5x on {POPULATION} candidates)")
