"""Shared helpers of the paper runners (port of ``benchmarks/common.py``):
the profiling cache, the grid geometry, fetching or profiling one grid,
fitting, the CSV line, and what one run cost on the card.

The reference's cache path and grid are module constants; here both are
arguments.  ``cache_path`` defaults to ``build/repro_torch/bench/
cnn_profile.json``, the port's own file (a datapoint's key names its grid
cell, not the framework or device that measured it, so the port never
shares a cache with the reference).  ``geometry`` defaults to ``FULL``:
full width at 32x32, batch sizes 2-256.  ``REFERENCE`` is the reference
runners' geometry, where the port prints their CSV lines exactly.
``grid_points`` drops the reference's ``collect_missing`` flag, which no
paper runner sets.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass

import torch

from repro_torch.core.dataset import (
    DEFAULT_BATCH_SIZES,
    DatasetCache,
    Datapoint,
    GridSpec,
    collect_grid,
)
from repro_torch.core.predictor import Perf4Sight
from repro_torch.kernels.build import BUILD_DIR
from repro_torch.kernels.conv_mm.kernel import conv_mm_cuda

__all__ = ["BENCH_DIR", "CACHE_PATH", "GRID_BS", "Geometry", "FULL", "REFERENCE",
           "cache", "grid_points", "fit_predictor", "csv_line", "card_tally"]

BENCH_DIR = BUILD_DIR / "bench"
CACHE_PATH = str(BENCH_DIR / "cnn_profile.json")

# five batch sizes across the paper's range [2, 256]
GRID_BS = (2, 16, 64, 128, 256)


@dataclass(frozen=True)
class Geometry:
    """Where every grid of a run is profiled: the networks' width
    multiplier and input size, the batch sizes of each grid, and the
    profiler's timed steps (``repeats``) and warm-up steps for every
    training profile the run makes.  Table 2's inference profiles of
    sub-networks take their own (``infer_repeats``, ``infer_warmup``):
    at full width φ at bs 1 is host time, which needs the median of
    more steps."""

    width_mult: float = 1.0
    input_hw: int = 32
    batch_sizes: tuple[int, ...] = GRID_BS
    repeats: int = 5
    warmup: int = 2
    infer_repeats: int = 10
    infer_warmup: int = 2

    @property
    def profile_kw(self) -> dict:
        return {"repeats": self.repeats, "warmup": self.warmup}

    @property
    def infer_kw(self) -> dict:
        return {"repeats": self.infer_repeats, "warmup": self.infer_warmup}


# full width at CIFAR's 32x32, the cnn cell's grid
FULL = Geometry()
# the reference runners' grid (GridSpec's defaults), collect_grid's steps
# and profile_inference's default steps
REFERENCE = Geometry(0.25, 16, DEFAULT_BATCH_SIZES, repeats=2, warmup=1,
                     infer_repeats=3, infer_warmup=1)


def cache(path: str = CACHE_PATH) -> DatasetCache:
    return DatasetCache(path)


def grid_points(c: DatasetCache, family: str, levels, strategy: str,
                geometry: Geometry = FULL, *, device="cuda") -> list[Datapoint]:
    """Fetch (or lazily profile on ``device``) the datapoints of one grid."""
    spec = GridSpec(family, tuple(levels), strategy, tuple(geometry.batch_sizes),
                    geometry.width_mult, geometry.input_hw)
    return collect_grid(spec, c, device=device, **geometry.profile_kw)


def fit_predictor(train_dps, seed=0, n_estimators=100) -> Perf4Sight:
    return Perf4Sight(n_estimators=n_estimators, seed=seed).fit(train_dps)


def csv_line(name: str, value: float, derived: str = "") -> str:
    return f"{name},{value:.6g},{derived}"


@contextmanager
def card_tally(name: str, print_fn, device: torch.device, c: DatasetCache):
    """Around one runner's work: on the card, print one line after it with
    the datapoints it profiled (new entries of ``c`` plus the ``profiled``
    count of the yielded dict, for profiles kept elsewhere), its seconds
    and the ``conv_mm`` launches it caused.  On the CPU it prints nothing."""
    counts = {"profiled": 0}
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    n0, launches0, t0 = len(c), conv_mm_cuda.launches, time.perf_counter()
    yield counts
    if on_card:
        torch.cuda.synchronize()
        print_fn(csv_line(f"{name}/card_s", time.perf_counter() - t0,
                          f"profiled={len(c) - n0 + counts['profiled']} "
                          f"conv_mm_launches={conv_mm_cuda.launches - launches0}"))
