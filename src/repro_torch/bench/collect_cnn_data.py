"""Collect the CNN profiling dataset of the paper runners (paper §5.1/§6)
into the port's on-disk cache (port of ``benchmarks/collect_cnn_data.py``).
Long-running; run once on the card:

    PYTHONPATH=src python -m repro_torch.bench.collect_cnn_data

Every datapoint is cached in ``build/repro_torch/bench/cnn_profile.json``
(or ``--cache``) so the collection is resumable and all paper runners
afterwards run from cache.  Grid layout, at the geometry of
``common.FULL`` (width 1.0, 32x32, batch sizes 2-256):

  fig3   : resnet18, mobilenetv2, squeezenet, mnasnet
           train  = random strategy, levels {0,30,50,70,90}%
           test   = random + L1 strategies, levels {10,40,60,80}%
  fig4   : + resnet50, googlenet test grids (basis generalisation)
  §6.2.1 : + resnet50 train grid (DNNMem comparison)
  §6.1   : alexnet, all 19 levels (training-set-size sweep)

The reference's ``--full`` flag is left out: its ``all_grids`` never reads
it, so the flag changes nothing there.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.core.dataset import (
    DEFAULT_TEST_LEVELS,
    DEFAULT_TRAIN_LEVELS,
    PAPER_ALL_LEVELS,
    GridSpec,
    collect_grid,
)
from repro_torch.device import resolve_device

from .common import CACHE_PATH, FULL, cache

FIG3_FAMILIES = ("resnet18", "mobilenetv2", "squeezenet", "mnasnet")
FIG4_EXTRA_FAMILIES = ("resnet50", "googlenet")


def all_grids(geometry=FULL) -> list[GridSpec]:
    bss, wm, hw = tuple(geometry.batch_sizes), geometry.width_mult, geometry.input_hw
    train_l, test_l = DEFAULT_TRAIN_LEVELS, DEFAULT_TEST_LEVELS
    grids: list[GridSpec] = []
    for fam in FIG3_FAMILIES:
        grids.append(GridSpec(fam, train_l, "random", bss, wm, hw))
        grids.append(GridSpec(fam, test_l, "random", bss, wm, hw))
        grids.append(GridSpec(fam, test_l, "l1", bss, wm, hw))
    for fam in FIG4_EXTRA_FAMILIES:
        grids.append(GridSpec(fam, test_l, "random", bss, wm, hw))
        grids.append(GridSpec(fam, test_l, "l1", bss, wm, hw))
    # §6.2.1 DNNMem comparison trains a same-network Γ model on ResNet50.
    grids.append(GridSpec("resnet50", train_l, "random", bss, wm, hw))
    # §6.1 training-set-size sweep: AlexNet across all 19 paper levels.
    grids.append(GridSpec("alexnet", PAPER_ALL_LEVELS, "random", bss, wm, hw))
    return grids


def collect(cache_path: str = CACHE_PATH, geometry=FULL, device="cuda") -> int:
    """Profile every missing point of ``all_grids`` into ``cache_path``;
    returns the points the cache then holds."""
    device = resolve_device(device)
    c = cache(cache_path)
    grids = all_grids(geometry)
    total_pts = sum(len(g.levels) * len(g.batch_sizes) for g in grids)
    print(f"collecting {total_pts} datapoints across {len(grids)} grids "
          f"({len(c)} already cached)", flush=True)
    t0 = time.time()
    done = 0
    for g in grids:
        print(f"[{time.time() - t0:7.1f}s] grid {g.family}/{g.strategy}/"
              f"levels={[round(l, 2) for l in g.levels]}", flush=True)
        collect_grid(g, c, verbose=True, device=device, **geometry.profile_kw)
        done += len(g.levels) * len(g.batch_sizes)
        print(f"[{time.time() - t0:7.1f}s] {done}/{total_pts} points done", flush=True)
    print(f"ALL DONE in {time.time() - t0:.0f}s — cache has {len(c)} points", flush=True)
    return len(c)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", default=CACHE_PATH)
    args = ap.parse_args()
    collect(args.cache)


if __name__ == "__main__":
    main()
