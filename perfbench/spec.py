"""Finds a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, one traffic mix, one step
kind or one metric sits in a file of its own, found by its name:

* ``configs/<config>.json`` (the ``file`` that ``BENCHMARK.json`` gives);
* ``traffic/<traffic>.json``: the parameters of the mix, and ``entry``,
  the step kind that runs it;
* ``entries/<entry>.py``: builds the program's step for the cell, draws
  its inputs, and compares with the reference (see ``entries/__init__``);
* ``limits/<workload>.json``: the limit of each number that decides
  ``correct``;
* ``e2e/<metric>.py`` and ``metrics/<metric>.py``: one reader per
  end-to-end and per-layer metric, ``read(ctx) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["HERE", "Cell", "load_benchmark", "resolve", "load_module", "reader"]

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list[dict] = field(default_factory=list)
    per_layer: list[dict] = field(default_factory=list)
    root: Path = HERE


def load_benchmark(root: Path = HERE) -> dict:
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_names: set[str] | None) -> bool:
    """A metric with ``workloads`` is reported in those cells; an
    end-to-end metric without it in every cell; a per-layer metric without
    it wherever its ``moves`` metric is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def resolve(workload: str, root: Path = HERE, bench: dict | None = None) -> Cell:
    """The cell named ``workload``, with its configuration, traffic,
    limits and the metrics it reports."""
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root.parent / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, None)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, e2e_names)]
    return Cell(workload, config, traffic, limits, int(w["chips"]), e2e, per_layer, root)


def load_module(path: Path):
    """The Python file at ``path`` as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench._loaded.{path.parent.name}.{path.stem}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str, root: Path = HERE):
    """The reader module of metric ``name``; ``kind`` is ``e2e`` or
    ``metrics``."""
    return load_module(root / kind / f"{name}.py")
