"""CPU tests of the benchmark (run with ``python -m pytest perfbench/tests``
from the root of the repository).  A test that needs the card carries the
``card`` marker and skips, deciding inside the test, where there is none."""

import copy
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


def small_config(config: dict, *, width: float = 0.25, hw: int = 16) -> dict:
    """``config`` at ``width`` and a ``hw`` x ``hw`` input: every width the
    reference's plan reads (the stem's, each stage's ``mid`` and ``out``,
    the head convolution's) scaled, the expansion factors, kernels and
    strides kept."""
    cfg = copy.deepcopy(config)
    cfg["width_mult"], cfg["input_hw"] = width, hw
    for part in [cfg["stem"], cfg.get("head_conv", {}), *cfg["stages"]]:
        for key in ("mid", "out"):
            if key in part:
                part[key] = int(part[key] * width)
    return cfg


def small_cell(workload: str, *, width: float = 0.25, hw: int = 16, bs: int = 4,
               root: Path | None = None, **traffic):
    """``workload``'s cell (found under ``root``, the benchmark's own by
    default) at a width, input and batch a CPU test can hold, with its
    limits as they stand."""
    from perfbench import spec

    cell = spec.resolve(workload, root or spec.HERE)
    tr = dict(cell.traffic, batch_size=bs, trace_steps=2, **traffic)
    return dataclasses.replace(cell, config=small_config(cell.config, width=width, hw=hw),
                               traffic=tr)


@pytest.fixture
def float64(monkeypatch):
    """The CNN entries' inputs and weights drawn as always, then held in
    float64, so that a sound run reads rounding alone."""
    from perfbench.entries import cnn_common

    draw = cnn_common.draw_inputs

    def draw64(*a, **k):
        leaves, x, y = draw(*a, **k)
        return [t.double() for t in leaves], x.double(), y

    monkeypatch.setattr(cnn_common, "draw_inputs", draw64)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
