"""Fig. 3 reproduction: same base network in training and test sets (port
of ``benchmarks/fig3_same_network.py``).

Per network: train the forests on random-pruned levels {0,30,50,70,90}%,
test on held-out levels with (a) random pruning (bars "Rand") and (b) L1
pruning (bars "L1").  Paper result: mean Γ error ≤ 9.15 %, Φ ≤ 14.7 %
(overall means 5.53 % / 9.37 %)."""

from __future__ import annotations

from repro_torch.core.dataset import DEFAULT_TEST_LEVELS, DEFAULT_TRAIN_LEVELS
from repro_torch.core.predictor import Perf4Sight
from repro_torch.device import resolve_device

from .common import CACHE_PATH, FULL, cache, card_tally, csv_line, grid_points

NETWORKS = ("resnet18", "mobilenetv2", "squeezenet", "mnasnet")


def run(print_fn=print, *, cache_path: str = CACHE_PATH, geometry=FULL,
        device="cuda") -> dict:
    """Two fits per network: the paper-faithful pure random forest
    (``forest``) and the beyond-paper ridge+forest hybrid (``hybrid``,
    default predictor) — both reported, per the reproduce-then-improve
    protocol."""
    device = resolve_device(device)
    c = cache(cache_path)
    results = {}
    all_errs = {("forest", "gamma"): [], ("forest", "phi"): [],
                ("hybrid", "gamma"): [], ("hybrid", "phi"): []}
    with card_tally("fig3", print_fn, device, c):
        for net in NETWORKS:
            train = grid_points(c, net, DEFAULT_TRAIN_LEVELS, "random", geometry,
                                device=device)
            models = {
                "forest": Perf4Sight(n_estimators=100, hybrid=False).fit(train),
                "hybrid": Perf4Sight(n_estimators=100, hybrid=True).fit(train),
            }
            for strat in ("random", "l1"):
                test = grid_points(c, net, DEFAULT_TEST_LEVELS, strat, geometry,
                                   device=device)
                tag = "Rand" if strat == "random" else "L1"
                for mname, model in models.items():
                    rep = model.evaluate(test)
                    results[(net, tag, mname)] = rep
                    all_errs[(mname, "gamma")].append(rep.gamma_mape)
                    all_errs[(mname, "phi")].append(rep.phi_mape)
                    print_fn(csv_line(f"fig3/{net}/{tag}/{mname}/gamma_err_pct",
                                      rep.gamma_mape * 100, f"n={rep.n}"))
                    print_fn(csv_line(f"fig3/{net}/{tag}/{mname}/phi_err_pct",
                                      rep.phi_mape * 100, f"n={rep.n}"))
        # the mean over the 8 (network, test grid) bars, as the reference
        for mname in ("forest", "hybrid"):
            g = float(sum(all_errs[(mname, "gamma")]) / 8 * 100)
            p = float(sum(all_errs[(mname, "phi")]) / 8 * 100)
            print_fn(csv_line(f"fig3/mean/{mname}/gamma_err_pct", g, "paper=5.53"))
            print_fn(csv_line(f"fig3/mean/{mname}/phi_err_pct", p, "paper=9.37"))
            results[("mean", mname)] = (g, p)
    return results


if __name__ == "__main__":
    run()
