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


def small_cell(workload: str, *, width: float = 0.25, hw: int = 16, bs: int = 4, **traffic):
    """``workload``'s cell at a width, input and batch a CPU test can hold,
    with its limits as they stand."""
    from perfbench import spec

    cell = spec.resolve(workload)
    cfg = copy.deepcopy(cell.config)
    cfg["width_mult"], cfg["input_hw"] = width, hw
    cfg["stem"]["out"] = int(cfg["stem"]["out"] * width)
    for s in cfg["stages"]:
        s["mid"], s["out"] = int(s["mid"] * width), int(s["out"] * width)
    tr = dict(cell.traffic, batch_size=bs, trace_steps=2, **traffic)
    return dataclasses.replace(cell, config=cfg, traffic=tr)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
