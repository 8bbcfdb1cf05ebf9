"""Table 2 / §6.4 reproduction: on-device model selection under constraints
(port of ``benchmarks/table2_case_study.py``).

The paper searches OFA-ResNet50 sub-networks by evolutionary search under
hard (Γ, γ, φ) budgets, with every candidate evaluated by the perf4sight
predictors (0.1 s) instead of on-device profiling (20 s) — a ~200× search
speed-up and no OOM risk.  Analogue here: the sub-network space is the
pruned-topology space of ResNet50 (per-group keep ratios = OFA sub-network
sampling).

Steps (mirroring the paper):
  1. Γ model: trained on the ResNet50 training grid (§6.2 protocol).
  2. γ/φ models: trained on profiled *inference* of N_TRAIN_SUB sampled
     sub-networks at small batch sizes (paper: 25 of 100 subnets, bs≤32),
     tested on held-out subnets (paper: 1.8 % γ, 4.4 % φ).
  3. ES under two constraint tiers (≈ A/B rows), predictor-gated.  At the
     reference's geometry they are the reference's fixed budgets; those
     mean nothing at another width, so there each tier's budgets come from
     ``budget_tiers``.
  4. Search-time comparison: predictor evals/s vs measured profile time.

The sub-network data are cached in ``sub_cache`` (default
``build/repro_torch/bench/ofa_subnets.json``, the reference's format);
like the reference's file it holds one geometry's profiles, so give each
geometry its own path.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from repro_torch.core import profiler
from repro_torch.core.dataset import DEFAULT_TRAIN_LEVELS
from repro_torch.core.features import network_features
from repro_torch.core.fileio import atomic_write_json
from repro_torch.core.predictor import Perf4Sight, mape
from repro_torch.core.search import Constraints, evolutionary_search, sample_subnetwork
from repro_torch.device import resolve_device
from repro_torch.engine import CostQuery, ForestBackend
from repro_torch.models.cnn import build_resnet50

from .common import (BENCH_DIR, CACHE_PATH, FULL, REFERENCE, cache, card_tally, csv_line,
                     fit_predictor, grid_points)

N_TRAIN_SUB, N_TEST_SUB = 10, 6
INFER_BS = (1, 2, 4, 8)
TRAIN_BS, SEARCH_INFER_BS = 16, 1
SEARCH = dict(population=32, iterations=40, seed=0)
SUB_CACHE = str(BENCH_DIR / "ofa_subnets.json")
# the reference's tiers, for the reference's geometry
REFERENCE_TIERS = {
    "A": Constraints(gamma_mb=18.0, gamma_inf_mb=6.0, phi_inf_ms=20.0,
                     train_bs=TRAIN_BS, infer_bs=SEARCH_INFER_BS),
    "B": Constraints(gamma_mb=12.0, gamma_inf_mb=4.0, phi_inf_ms=10.0,
                     train_bs=TRAIN_BS, infer_bs=SEARCH_INFER_BS),
}
# a budgeted tier leaves at least this many candidates of the search's
# first population feasible, as the predictors see them
FEASIBLE_FIRST = 4


def subnet_inference_data(sub_cache: str = SUB_CACHE, geometry=FULL,
                          device="cuda") -> tuple[list[dict], int]:
    """The sub-networks' rows, read from ``sub_cache`` or profiled on
    ``device`` and written there: (rows, profiles made).  Every profile
    takes the geometry's timed and warm-up steps: ``infer_kw`` for the
    inference profiles, ``profile_kw`` for the training one."""
    if os.path.exists(sub_cache):
        with open(sub_cache) as f:
            return json.load(f), 0
    hw = geometry.input_hw
    base = build_resnet50(width_mult=geometry.width_mult, input_hw=hw)
    data = []
    for i in range(N_TRAIN_SUB + N_TEST_SUB):
        rng = np.random.default_rng(2000 + i)
        m = build_resnet50(widths=sample_subnetwork(base.widths, rng), input_hw=hw)
        m.name = f"r50-sub{i}"
        spec = m.conv_specs()
        for bs in INFER_BS:
            t0 = time.perf_counter()
            res = profiler.profile_inference(m, bs, device=device, **geometry.infer_kw)
            data.append({
                "sub": i, "bs": bs,
                "gamma": res.gamma_mb, "phi": res.phi_ms,
                "features": [float(v) for v in network_features(spec, bs)],
                "profile_s": time.perf_counter() - t0,
            })
        # one training-Γ validation point per subnet at the search batch size
        t0 = time.perf_counter()
        tres = profiler.profile_training(m, TRAIN_BS, device=device, **geometry.profile_kw)
        data.append({
            "sub": i, "bs": TRAIN_BS, "train": True,
            "gamma": tres.gamma_mb, "phi": tres.phi_ms,
            "features": [float(v) for v in network_features(spec, TRAIN_BS)],
            "profile_s": time.perf_counter() - t0,
        })
    atomic_write_json(sub_cache, data)
    return data, len(data)


def budget_tiers(estimate, measured, *, width_mult: float, input_hw: int):
    """Tiers A and B from measurements, for a geometry where fixed budgets
    mean nothing.

    ``measured`` holds three rows: Γ of the sub-networks at ``TRAIN_BS``,
    and γ and φ at ``SEARCH_INFER_BS``.  ``estimate`` answers a list of
    :class:`CostQuery` (an engine's or a backend's) and predicts the
    search's first population (its rng draws it first from ``SEARCH``'s
    seed).  A
    budget at a quantile of the measurements can lie below every prediction
    (φ at bs 1 on the card is host time, which the forest does not follow),
    so each metric's budget is the larger of the quantile of the
    measurements and that of the predicted first population: then it binds
    on its own.  Together the three may leave no first candidate feasible,
    so the budget is raised uniformly, by the least factor that leaves
    ``FEASIBLE_FIRST`` of them feasible, and B's is held inside A's.  A
    takes the median, B the 25th percentile.

    Returns ``(tiers, notes, best_first, pred)``: the two
    :class:`Constraints`, a sentence on how each was set, the best fitness
    among the first candidates feasible under each tier (and ``"MAX"``,
    under none), and the first population's predictions (Γ, γ, φ) per
    candidate."""
    base = build_resnet50(width_mult=width_mult, input_hw=input_hw)
    rng = np.random.default_rng(SEARCH["seed"])
    first_w = [sample_subnetwork(base.widths, rng) for _ in range(SEARCH["population"])]
    first = [build_resnet50(widths=w, input_hw=input_hw).conv_specs() for w in first_w]
    first_fit = np.array([sum(w.values()) for w in first_w], dtype=float)
    pred = np.array([[t.gamma_mb, i.gamma_mb, i.phi_ms] for t, i in zip(
        estimate([CostQuery(spec=n, bs=TRAIN_BS, stage="train") for n in first]),
        estimate([CostQuery(spec=n, bs=SEARCH_INFER_BS, stage="infer") for n in first]))])
    measured = np.asarray(measured, dtype=float)
    tiers, notes, best_first = {}, {}, {"MAX": first_fit.max()}
    cap = np.full(3, np.inf)
    for name, q in (("A", 50), ("B", 25)):
        quant = np.maximum(np.percentile(measured, q, axis=1), np.percentile(pred, q, axis=0))
        for raise_by in np.unique(np.append((pred / quant).max(axis=1), 1.0)):
            budget = np.minimum(cap, quant * max(raise_by, 1.0))
            feasible = (pred <= budget).all(axis=1)
            if feasible.sum() >= FEASIBLE_FIRST:
                break
        else:
            raise RuntimeError(f"tier {name}: no budget leaves {FEASIBLE_FIRST} feasible")
        cap = budget
        best_first[name] = first_fit[feasible].max()
        tiers[name] = Constraints(gamma_mb=float(budget[0]), gamma_inf_mb=float(budget[1]),
                                  phi_inf_ms=float(budget[2]), train_bs=TRAIN_BS,
                                  infer_bs=SEARCH_INFER_BS)
        notes[name] = (
            f"Γ <= {budget[0]:.2f} MB, γ <= {budget[1]:.2f} MB, φ <= {budget[2]:.4f} ms; "
            f"the larger of the {'median' if q == 50 else '25th percentile'} of the "
            f"sub-networks' measurements ({', '.join(f'{v:.4g}' for v in np.percentile(measured, q, axis=1))}) "
            f"and of the predicted first population ({', '.join(f'{v:.4g}' for v in np.percentile(pred, q, axis=0))}), "
            f"raised x{max(raise_by, 1.0):.4f}{' and held inside A' if name == 'B' else ''}: "
            f"{int(feasible.sum())} first candidates feasible, the best of fitness "
            f"{best_first[name]:.0f}")
    return tiers, notes, best_first, pred


def run(print_fn=print, *, cache_path: str = CACHE_PATH, sub_cache: str = SUB_CACHE,
        geometry=FULL, device="cuda") -> dict:
    device = resolve_device(device)
    c = cache(cache_path)
    with card_tally("table2", print_fn, device, c) as counts:
        # 1. Γ model from the §6.2 grid
        gamma_model = fit_predictor(
            grid_points(c, "resnet50", DEFAULT_TRAIN_LEVELS, "random", geometry,
                        device=device))

        # 2. γ/φ inference models from sampled sub-networks
        data, counts["profiled"] = subnet_inference_data(sub_cache, geometry, device)
        inf = [d for d in data if not d.get("train")]
        train_rows = [d for d in inf if d["sub"] < N_TRAIN_SUB]
        test_rows = [d for d in inf if d["sub"] >= N_TRAIN_SUB]
        Xtr = np.array([d["features"] for d in train_rows])
        infer_model = Perf4Sight(n_estimators=100, seed=0).fit_arrays(
            Xtr, np.array([d["gamma"] for d in train_rows]),
            np.array([d["phi"] for d in train_rows]))
        Xte = np.array([d["features"] for d in test_rows])
        pg, pp = infer_model.predict_features(Xte)
        g_err = mape(pg, np.array([d["gamma"] for d in test_rows])) * 100
        p_err = mape(pp, np.array([d["phi"] for d in test_rows])) * 100
        print_fn(csv_line("table2/infer_gamma_err_pct", g_err, "paper=1.8"))
        print_fn(csv_line("table2/infer_phi_err_pct", p_err, "paper=4.4"))

        # Γ generalisation to sampled subnets (paper: 4.28 % on OFA samples)
        tr_rows = [d for d in data if d.get("train")]
        Xg = np.array([d["features"] for d in tr_rows])
        pgt, _ = gamma_model.predict_features(Xg)
        g_sub_err = mape(pgt, np.array([d["gamma"] for d in tr_rows])) * 100
        print_fn(csv_line("table2/train_gamma_subnet_err_pct", g_sub_err,
                          "paper=4.28"))

        # 3. ES under constraint tiers (predictor-gated)
        mean_profile_s = float(np.mean([d["profile_s"] for d in data]))
        if (geometry.width_mult, geometry.input_hw) == (REFERENCE.width_mult,
                                                        REFERENCE.input_hw):
            tiers = REFERENCE_TIERS
        else:
            at_bs1 = [d for d in inf if d["bs"] == SEARCH_INFER_BS]
            measured = [[d["gamma"] for d in tr_rows], [d["gamma"] for d in at_bs1],
                        [d["phi"] for d in at_bs1]]
            tiers = budget_tiers(ForestBackend(train=gamma_model, infer=infer_model).estimate,
                                 measured, width_mult=geometry.width_mult,
                                 input_hw=geometry.input_hw)[0]
            for name, t in tiers.items():
                print_fn(csv_line(f"table2/ES_{name}/gamma_budget_mb", t.gamma_mb,
                                  f"gamma_inf={t.gamma_inf_mb:.2f}MB "
                                  f"phi_inf={t.phi_inf_ms:.4f}ms"))
        results = {"infer_gamma_err": g_err, "infer_phi_err": p_err,
                   "train_gamma_subnet_err": g_sub_err}
        for name, cons in tiers.items():
            r = evolutionary_search(
                "resnet50", (gamma_model, infer_model), cons,
                width_mult=geometry.width_mult, input_hw=geometry.input_hw, **SEARCH)
            evals_s = r.evaluations / max(r.search_time_s, 1e-9)
            naive_s = r.evaluations * mean_profile_s
            speedup = naive_s / max(r.search_time_s, 1e-9)
            print_fn(csv_line(f"table2/ES_{name}/fitness", r.fitness,
                              f"gamma={r.gamma_mb:.1f}MB phi_inf={r.phi_inf_ms:.1f}ms"))
            print_fn(csv_line(f"table2/ES_{name}/search_time_s", r.search_time_s,
                              f"naive={naive_s:.0f}s speedup={speedup:.0f}x"))
            results[f"ES_{name}"] = {
                "fitness": r.fitness, "time_s": r.search_time_s,
                "naive_s": naive_s, "speedup": speedup,
                "evals_per_s": evals_s, "widths_sum": sum(r.widths.values()),
            }
    return results


if __name__ == "__main__":
    run()
