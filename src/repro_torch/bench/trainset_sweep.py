"""§6.1 reproduction: tuning the training-set size on AlexNet (port of
``benchmarks/trainset_sweep.py``).

Train-set sizes 1..8 pruning levels (T₁={0} … T₈={0,10,20,30,50,60,70,90}),
test on the remaining levels.  Paper: error falls from 33–74 % at |T|=1 and
plateaus at 3–6 % from T={0,30,50,70,90} — which is why T₅ is the training
set everywhere else."""

from __future__ import annotations

from repro_torch.core.dataset import PAPER_ALL_LEVELS
from repro_torch.device import resolve_device

from .common import CACHE_PATH, FULL, cache, card_tally, csv_line, fit_predictor, grid_points

T_SETS = [
    (0.0,),
    (0.0, 0.50),
    (0.0, 0.50, 0.90),
    (0.0, 0.30, 0.50, 0.90),
    (0.0, 0.30, 0.50, 0.70, 0.90),
    (0.0, 0.20, 0.30, 0.50, 0.70, 0.90),
    (0.0, 0.10, 0.20, 0.30, 0.50, 0.70, 0.90),
    (0.0, 0.10, 0.20, 0.30, 0.50, 0.60, 0.70, 0.90),
]


def run(print_fn=print, *, cache_path: str = CACHE_PATH, geometry=FULL,
        device="cuda") -> list[tuple[int, float, float]]:
    device = resolve_device(device)
    c = cache(cache_path)
    out = []
    with card_tally("trainset", print_fn, device, c):
        all_pts = grid_points(c, "alexnet", PAPER_ALL_LEVELS, "random", geometry,
                              device=device)
        by_level = {}
        for dp in all_pts:
            by_level.setdefault(round(dp.level, 2), []).append(dp)
        for T in T_SETS:
            train, test = [], []
            tset = {round(l, 2) for l in T}
            for lvl, dps in by_level.items():
                (train if lvl in tset else test).extend(dps)
            rep = fit_predictor(train).evaluate(test)
            out.append((len(T), rep.gamma_mape * 100, rep.phi_mape * 100))
            print_fn(csv_line(f"trainset/|T|={len(T)}/gamma_err_pct",
                              rep.gamma_mape * 100))
            print_fn(csv_line(f"trainset/|T|={len(T)}/phi_err_pct",
                              rep.phi_mape * 100))
    return out


if __name__ == "__main__":
    run()
