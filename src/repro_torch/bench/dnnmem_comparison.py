"""§6.2.1 reproduction: memory-prediction protocol vs DNNMem (port of
``benchmarks/dnnmem_comparison.py``).

The paper profiles ResNet50 (server GPU), trains the Γ forest on pruning
levels {0,30,50,70,90} and reports 2.45 % memory error across batch sizes and
topologies, vs DNNMem's 17.4 %.  Here: the same protocol on the card's
ResNet50 (Γ ground truth = ``torch.cuda.max_memory_allocated`` over one
training step, ``repro_torch.core.profiler``)."""

from __future__ import annotations

from repro_torch.core.dataset import DEFAULT_TEST_LEVELS, DEFAULT_TRAIN_LEVELS
from repro_torch.device import resolve_device

from .common import CACHE_PATH, FULL, cache, card_tally, csv_line, fit_predictor, grid_points


def run(print_fn=print, *, cache_path: str = CACHE_PATH, geometry=FULL,
        device="cuda") -> float:
    device = resolve_device(device)
    c = cache(cache_path)
    with card_tally("dnnmem", print_fn, device, c):
        train = grid_points(c, "resnet50", DEFAULT_TRAIN_LEVELS, "random", geometry,
                            device=device)
        test = grid_points(c, "resnet50", DEFAULT_TEST_LEVELS, "random", geometry,
                           device=device)
        model = fit_predictor(train)
        rep = model.evaluate(test)
        print_fn(csv_line("dnnmem/resnet50/gamma_err_pct", rep.gamma_mape * 100,
                          "paper=2.45 dnnmem=17.4"))
    return rep.gamma_mape * 100


if __name__ == "__main__":
    run()
