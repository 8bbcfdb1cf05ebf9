"""Profiling-grid construction (paper §5.1.1 / §6.1) with an on-disk cache.

(Port of ``repro/core/dataset.py``.  ``Datapoint`` and its ``key`` are
the reference's, so a cache written by either package loads in the other;
the port profiles on the card through :mod:`repro_torch.core.profiler`,
and ``collect_grid`` takes ``device=``.  Keep the port's datapoints in a
cache file of their own: a key names the grid cell, not the framework or
the device that measured it.)

The degrees of freedom are pruning level, pruning strategy and batch size.
Paper values: 25 batch sizes in [2, 256], levels {5x | x ∈ [0, 18]}, training
set T = {0, 30, 50, 70, 90} (tuned on AlexNet, §6.1), random strategy for the
training set, random + L1 for the test sets.

The reproduction keeps the protocol but scales the grid to the 1-core CPU
host (see DESIGN.md §5): profile-scale networks (width_mult, input_hw are
hyperparameters of the grid) and a reduced default batch/level grid.  The
``full`` preset restores the paper grid.

Every profiled datapoint is cached as JSON keyed by its full configuration,
so benchmarks re-run instantly and long collections can resume after
interruption (the same property the real toolflow needs on a flaky edge
fleet).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

import numpy as np

from repro_torch.core import pruning as pr
from repro_torch.core.fileio import atomic_write_json, load_json_tolerant
from repro_torch.core.features import network_features
from repro_torch.core.profiler import profile_training
from repro_torch.device import resolve_device
from repro_torch.models.cnn import CNN_BUILDERS

__all__ = [
    "Datapoint",
    "GridSpec",
    "PAPER_TRAIN_LEVELS",
    "paper_test_levels",
    "default_grid",
    "collect_grid",
    "DatasetCache",
    "features_targets",
]

# Paper §6.1: T tuned on AlexNet; test = {5x | x in [0,18]} \ T.
PAPER_TRAIN_LEVELS = (0.0, 0.30, 0.50, 0.70, 0.90)
PAPER_ALL_LEVELS = tuple(0.05 * x for x in range(19))

# Reduced CPU-host defaults (protocol unchanged, grid subsampled).
DEFAULT_TRAIN_LEVELS = PAPER_TRAIN_LEVELS
DEFAULT_TEST_LEVELS = (0.10, 0.40, 0.60, 0.80)
DEFAULT_BATCH_SIZES = (2, 8, 16, 32)
PAPER_BATCH_SIZES = (2, 4, 8, 16, 32, 64, 70, 80, 90, 100, 110, 120, 128, 140,
                     150, 160, 170, 180, 190, 200, 210, 220, 230, 240, 256)


def paper_test_levels(train=PAPER_TRAIN_LEVELS) -> tuple[float, ...]:
    return tuple(l for l in PAPER_ALL_LEVELS if round(l * 100) not in
                 {round(t * 100) for t in train})


@dataclass(frozen=True)
class GridSpec:
    family: str
    levels: tuple[float, ...]
    strategy: str = "random"
    batch_sizes: tuple[int, ...] = DEFAULT_BATCH_SIZES
    width_mult: float = 0.25
    input_hw: int = 16
    seed: int = 0


@dataclass
class Datapoint:
    family: str
    level: float
    strategy: str
    bs: int
    width_mult: float
    input_hw: int
    seed: int
    gamma_mb: float
    phi_ms: float
    # Measured step energy in joules; 0.0 = no power rail sampled (the
    # calibration energy fit then targets the envelope watts-proxy).
    energy_j: float = 0.0
    features: list[float] = field(default_factory=list)

    @property
    def key(self) -> str:
        return (
            f"{self.family}|l={self.level:.2f}|s={self.strategy}|bs={self.bs}"
            f"|wm={self.width_mult}|hw={self.input_hw}|seed={self.seed}"
        )


def default_grid(family: str, *, full: bool = False) -> list[GridSpec]:
    """Train + test grids for one network family (fig3 protocol)."""
    if full:
        train_l, test_l, bss = PAPER_TRAIN_LEVELS, paper_test_levels(), PAPER_BATCH_SIZES
    else:
        train_l, test_l, bss = DEFAULT_TRAIN_LEVELS, DEFAULT_TEST_LEVELS, DEFAULT_BATCH_SIZES
    return [
        GridSpec(family, train_l, "random", bss),
        GridSpec(family, test_l, "random", bss),
        GridSpec(family, test_l, "l1", bss),
    ]


class DatasetCache:
    """JSON-file cache of profiled datapoints, write-atomic and append-only.

    Writes go to a tempfile in the target directory, are fsync'd, then
    ``os.replace``d over the cache — an interrupted collection run can never
    leave a truncated cache behind.  A corrupt cache file (e.g. written by a
    pre-atomic version, or a torn disk) is quarantined to ``<path>.corrupt``
    and collection restarts from empty instead of crashing the run.
    """

    def __init__(self, path: str):
        self.path = path
        self._data: dict[str, dict] = load_json_tolerant(path)

    def get(self, key: str) -> Datapoint | None:
        d = self._data.get(key)
        return Datapoint(**d) if d else None

    def put(self, dp: Datapoint) -> None:
        self._data[dp.key] = asdict(dp)

    def flush(self) -> None:
        atomic_write_json(self.path, self._data)

    def __len__(self) -> int:
        return len(self._data)


def _build_pruned(spec: GridSpec, level: float) -> "object":
    build = CNN_BUILDERS[spec.family]
    base = build(width_mult=spec.width_mult, input_hw=spec.input_hw)
    rng = np.random.default_rng(spec.seed + int(level * 100))
    scores = pr.l1_scores(base, spec.seed) if spec.strategy == "l1" else None
    widths = pr.prune_widths(base.widths, level, spec.strategy, rng, scores=scores)
    m = build(widths=widths, input_hw=spec.input_hw)
    m.name = f"{spec.family}-p{int(level * 100)}-{spec.strategy}"
    return m


def collect_grid(
    spec: GridSpec,
    cache: DatasetCache | None = None,
    *,
    repeats: int = 2,
    warmup: int = 1,
    verbose: bool = False,
    device="cuda",
) -> list[Datapoint]:
    """Profile every (level × batch size) cell of ``spec`` (cache-aware) on
    ``device``.

    One topology is built per level, then profiled across all batch sizes —
    mirroring Fig. 1's pruning process → data collection process split.
    """
    device = resolve_device(device)
    out: list[Datapoint] = []
    for level in spec.levels:
        model = _build_pruned(spec, level)
        net_spec = model.conv_specs()
        for bs in spec.batch_sizes:
            dp = Datapoint(
                family=spec.family, level=level, strategy=spec.strategy, bs=bs,
                width_mult=spec.width_mult, input_hw=spec.input_hw, seed=spec.seed,
                gamma_mb=0.0, phi_ms=0.0,
            )
            cached = cache.get(dp.key) if cache is not None else None
            if cached is not None:
                out.append(cached)
                continue
            res = profile_training(model, bs, repeats=repeats, warmup=warmup,
                                   seed=spec.seed, device=device)
            dp.gamma_mb = res.gamma_mb
            dp.phi_ms = res.phi_ms
            dp.features = [float(v) for v in network_features(net_spec, bs)]
            out.append(dp)
            if cache is not None:
                cache.put(dp)
                cache.flush()
            if verbose:
                print(
                    f"  {dp.key}: gamma={dp.gamma_mb:.1f}MB phi={dp.phi_ms:.1f}ms "
                    f"(first call {res.compile_s:.1f}s)",
                    flush=True,
                )
    return out


def features_targets(dps: list[Datapoint]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(X, gamma, phi) arrays from datapoints (features must be populated)."""
    X = np.array([dp.features for dp in dps], dtype=np.float64)
    g = np.array([dp.gamma_mb for dp in dps])
    p = np.array([dp.phi_ms for dp in dps])
    return X, g, p
