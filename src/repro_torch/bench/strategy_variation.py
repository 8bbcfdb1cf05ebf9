"""§6.2 reproduction: 100 random pruning strategies on MobileNetV2 @ 50 %
(port of ``benchmarks/strategy_variation.py``).

The paper prunes MobileNetV2 to 50 % with 100 random strategies (uniform +
early/middle/late-biased) at batch size 80, and the models — trained on the
uniform-random strategy only — predict Γ and Φ with 1.32 % / 9.90 % mean
error despite 4423±1597 MB / 1741±871 ms attribute spread.

Scaled as the reference: ``N_STRATEGIES`` strategies at one batch size,
each a real profile on the card (at the run's geometry, not the
reference's fixed width 0.25 and 16x16)."""

from __future__ import annotations

import numpy as np

from repro_torch.core import profiler
from repro_torch.core import pruning as pr
from repro_torch.core.dataset import DEFAULT_TRAIN_LEVELS, Datapoint
from repro_torch.core.features import network_features
from repro_torch.device import resolve_device
from repro_torch.engine import CostQuery, ForestBackend
from repro_torch.models.cnn import build_mobilenetv2

from .common import CACHE_PATH, FULL, cache, card_tally, csv_line, fit_predictor, grid_points

N_STRATEGIES = 8
BS = 16
LEVEL = 0.5
PROFILES = ("uniform", "early", "middle", "late")


def strategy_models(geometry=FULL) -> list:
    """The ``N_STRATEGIES`` pruned MobileNetV2s: the four position profiles,
    then Dirichlet-random allocations, strategy ``i`` drawn from seed
    ``1000 + i``."""
    base = build_mobilenetv2(width_mult=geometry.width_mult, input_hw=geometry.input_hw)
    models = []
    for i in range(N_STRATEGIES):
        rng = np.random.default_rng(1000 + i)
        if i < len(PROFILES):
            widths = pr.prune_widths(base.widths, LEVEL, PROFILES[i], rng)
        else:
            widths = pr.random_profile_widths(base.widths, LEVEL, rng)
        m = build_mobilenetv2(widths=widths, input_hw=geometry.input_hw)
        m.name = f"mbv2-strat{i}"
        models.append(m)
    return models


def run(print_fn=print, *, cache_path: str = CACHE_PATH, geometry=FULL,
        device="cuda") -> dict:
    device = resolve_device(device)
    c = cache(cache_path)
    with card_tally("strategies", print_fn, device, c):
        train = grid_points(c, "mobilenetv2", DEFAULT_TRAIN_LEVELS, "random", geometry,
                            device=device)
        model = fit_predictor(train)

        gammas, phis, specs = [], [], []
        for i, m in enumerate(strategy_models(geometry)):
            key = Datapoint(family="mobilenetv2", level=LEVEL, strategy=f"strat{i}",
                            bs=BS, width_mult=geometry.width_mult,
                            input_hw=geometry.input_hw, seed=0, gamma_mb=0, phi_ms=0)
            hit = c.get(key.key)
            if hit is None:
                res = profiler.profile_training(m, BS, device=device, **geometry.profile_kw)
                key.gamma_mb, key.phi_ms = res.gamma_mb, res.phi_ms
                key.features = [float(v) for v in
                                network_features(m.conv_specs(), BS)]
                c.put(key)
                c.flush()
                hit = key
            specs.append(m.conv_specs())
            gammas.append(hit.gamma_mb)
            phis.append(hit.phi_ms)

        # one batched engine call for all strategies (no scalar round-trips)
        ests = ForestBackend(train=model).estimate(
            [CostQuery(spec=s, bs=BS, stage="train") for s in specs])
        errs_g = [abs(e.gamma_mb - g) / g for e, g in zip(ests, gammas)]
        errs_p = [abs(e.phi_ms - p) / p for e, p in zip(ests, phis)]

        out = {
            "gamma_mean": float(np.mean(gammas)), "gamma_std": float(np.std(gammas)),
            "phi_mean": float(np.mean(phis)), "phi_std": float(np.std(phis)),
            "gamma_err": float(np.mean(errs_g)) * 100,
            "phi_err": float(np.mean(errs_p)) * 100,
        }
        print_fn(csv_line("strategies/gamma_spread_mb", out["gamma_std"],
                          f"mean={out['gamma_mean']:.1f}"))
        print_fn(csv_line("strategies/phi_spread_ms", out["phi_std"],
                          f"mean={out['phi_mean']:.1f}"))
        print_fn(csv_line("strategies/gamma_err_pct", out["gamma_err"], "paper=1.32"))
        print_fn(csv_line("strategies/phi_err_pct", out["phi_err"], "paper=9.90"))
    return out


if __name__ == "__main__":
    run()
