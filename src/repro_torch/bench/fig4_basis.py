"""Fig. 4 reproduction: training on a *basis* of networks (ResNet18,
MobileNetV2, SqueezeNet), predicting for networks not in the basis
(ResNet50, MnasNet, GoogLeNet) as well as the basis networks themselves
(port of ``benchmarks/fig4_basis.py``).

Paper finding: basis networks stay close to Fig. 3 error; unseen networks
degrade by +5.6 pp (ResNet50), +2.55 pp (MnasNet), +16 pp (GoogLeNet) —
sharing building blocks with the basis is what matters (App. C)."""

from __future__ import annotations

from repro_torch.core.dataset import DEFAULT_TEST_LEVELS, DEFAULT_TRAIN_LEVELS
from repro_torch.device import resolve_device

from .common import CACHE_PATH, FULL, cache, card_tally, csv_line, fit_predictor, grid_points

BASIS = ("resnet18", "mobilenetv2", "squeezenet")
UNSEEN = ("mnasnet", "resnet50", "googlenet")


def run(print_fn=print, *, cache_path: str = CACHE_PATH, geometry=FULL,
        device="cuda") -> dict:
    device = resolve_device(device)
    c = cache(cache_path)
    results = {}
    with card_tally("fig4", print_fn, device, c):
        train = []
        for net in BASIS:
            train += grid_points(c, net, DEFAULT_TRAIN_LEVELS, "random", geometry,
                                 device=device)
        model = fit_predictor(train)
        for net in BASIS + UNSEEN:
            for strat in ("random", "l1"):
                test = grid_points(c, net, DEFAULT_TEST_LEVELS, strat, geometry,
                                   device=device)
                rep = model.evaluate(test)
                tag = "Rand" if strat == "random" else "L1"
                kind = "basis" if net in BASIS else "unseen"
                results[(net, tag)] = rep
                print_fn(csv_line(f"fig4/{net}/{tag}/gamma_err_pct",
                                  rep.gamma_mape * 100, kind))
                print_fn(csv_line(f"fig4/{net}/{tag}/phi_err_pct",
                                  rep.phi_mape * 100, kind))
    return results


if __name__ == "__main__":
    run()
