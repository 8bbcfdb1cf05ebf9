"""The harness on the CPU: the result line's shape, the refusals, the
import check, and files found by their names."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import faults, imports, spec
from perfbench.run import run

from .conftest import ROOT, small_cell

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, trace, capsys, seconds=0.3, **kw):
    rc = run(cell, 2**31 + 77, seconds, trace, "cpu", **kw)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("workload", ["resnet50-train-bs256", "resnet18-train-bs512",
                                      "resnet50-infer-bs512"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_shape(workload, trace, capsys):
    cell = small_cell(workload)
    rc, out, err = _run(cell, trace, capsys)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[: len(RESULT_KEYS)] == RESULT_KEYS
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # a CPU run reads no device metric: the readers find nothing
        assert line["metrics"] == {}
    else:
        names = {m["name"] for m in cell.end_to_end}
        assert set(line["metrics"]) == names - {"peak_mem_gb"}   # no allocator peak here
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}
    tail = err.strip().splitlines()[-len(cell.limits):]
    assert [t.split()[1] for t in tail] == list(cell.limits)
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_cli_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "resnet50-infer-bs512", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "refused" in proc.stderr


def test_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files:
    the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; "
            "from perfbench import spec; from perfbench.run import run; "
            "sys.exit(run(spec.resolve('resnet50-infer-bs512'), 1, 0.1, False, 'cpu'))")
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "repro_torch" in proc.stderr


def test_import_check_compares_whole_top_level_names():
    names = ["repro_torch", "repro_torch.core.profiler", "repro", "repro.core",
             "jax", "jaxlib.xla_client", "flax.linen", "reprox", "jax_like", "perfbench"]
    assert imports.forbidden(names) == ["flax.linen", "jax", "jaxlib.xla_client",
                                        "repro", "repro.core"]


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_sources_import_no_jax_and_the_reference_nothing_of_the_program():
    for path in (ROOT / "perfbench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imported(path)}
        assert not tops & imports.FORBIDDEN, path
        if "reference" in path.parts:
            assert "repro_torch" not in tops, path
    assert not (ROOT / "perfbench" / "reference").joinpath("conv_ref.py").exists()


def test_run_loads_no_jax(capsys):
    """The process that ran a cell on the CPU holds no forbidden module."""
    code = ("import sys; sys.path[:0] = [sys.argv[1] + '/src', sys.argv[1], "
            "sys.argv[1] + '/perfbench/tests']; "
            "from conftest import small_cell; from perfbench.run import run; "
            "from perfbench import imports; "
            "rc = run(small_cell('resnet50-infer-bs512'), 3, 0.1, False, 'cpu'); "
            "print('FOUND', imports.forbidden()); sys.exit(rc)")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FOUND []" in proc.stdout


def test_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, limits and a per-layer metric added
    as files beside the others, with entries in BENCHMARK.json, are found
    without an edit to any file that is there."""
    root = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", root, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "configs" / "resnet18-cifar100.json").read_text())
    cfg["name"] = "resnet18-wide"
    (root / "configs" / "resnet18-wide.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "traffic" / "train-bs512.json").read_text())
    (root / "traffic" / "train-bs64.json").write_text(json.dumps(dict(tr, batch_size=64)))
    (root / "limits" / "resnet18-train-bs64.json").write_text(
        (root / "limits" / "resnet18-train-bs512.json").read_text())
    (root / "metrics" / "conv_mm.calls_per_step.py").write_text(
        "UNIT = 'calls'\nBETTER = 'lower'\nMOVES = 'images_per_s'\n\n\n"
        "def read(ctx):\n    return 42.0\n")
    bench["configs"].append({"name": "resnet18-wide", "source": "x",
                             "file": "perfbench/configs/resnet18-wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "resnet18-train-bs64", "config": "resnet18-wide",
                               "traffic": "train-bs64", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "conv_mm.calls_per_step", "unit": "calls",
                               "better": "lower", "source": "device_trace",
                               "layer": "kernel conv_mm", "moves": "images_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("resnet18-train-bs64", root)
    assert cell.config["name"] == "resnet18-wide" and cell.traffic["batch_size"] == 64
    names = [m["name"] for m in cell.per_layer]
    assert "conv_mm.calls_per_step" in names and "conv_mm.roofline_pct" not in names
    assert spec.reader("metrics", "conv_mm.calls_per_step", root).read(None) == 42.0
    # the metric without a cell list is reported wherever images_per_s is
    assert "conv_mm.calls_per_step" in [m["name"] for m in
                                        spec.resolve("resnet50-infer-bs512", root).per_layer]


MBV2 = "mobilenetv2-224-train-bs256"
MBV2_READER = '''"""``step.mfu_pct``, reported in the MobileNetV2 cells."""

from pathlib import Path

from perfbench.spec import load_module

_base = load_module(Path(__file__).with_name("step.mfu_pct.py"))
UNIT, BETTER, MOVES, read = _base.UNIT, _base.BETTER, _base.MOVES, _base.read
'''


def _with_mobilenetv2(tmp_path) -> Path:
    """A copy of the benchmark that holds a MobileNetV2 cell at 224 x 224,
    added as new files (the configuration and limits kept in ``tests/``, a
    per-layer reader of its own) and new entries in BENCHMARK.json; every
    file that was there is left as it was."""
    root = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    shutil.copy(root / "tests" / "configs" / "mobilenetv2-224-c100.json", root / "configs")
    shutil.copy(root / "tests" / "limits" / f"{MBV2}.json", root / "limits")
    (root / "metrics" / "mbnet.step.mfu_pct.py").write_text(MBV2_READER)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mobilenetv2-224-c100", "source": "x",
                             "file": "perfbench/configs/mobilenetv2-224-c100.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": MBV2, "config": "mobilenetv2-224-c100",
                               "traffic": "train-bs256", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "mbnet.step.mfu_pct", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "step",
                               "moves": "images_per_s", "workloads": [MBV2]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())
    return root


@pytest.mark.parametrize("fault", ["none"] + sorted(faults.FAULTS))
def test_a_mobilenetv2_cell_goes_in_from_new_files(tmp_path, fault, float64, capsys):
    """The cell runs on the CPU at width 0.25, 32 x 32, batch 8, in float64
    (where a sound run reads rounding alone): unbroken it is correct, with
    each fault a training cell can have it is not.  (MobileNetV2 halves the
    input five times: at 16 x 16 and batch 4 its last BatchNorms normalise
    4 numbers a channel and the steps after the checked ones overflow.)"""
    cell = small_cell(MBV2, root=_with_mobilenetv2(tmp_path), hw=32, bs=8)
    assert cell.config["block"] == "inverted_residual"
    assert [m["name"] for m in cell.per_layer] == ["mbnet.step.mfu_pct"]
    rc, out, _ = _run(cell, False, capsys, program=faults.FAULTS.get(fault))
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] == (fault == "none"), line["checks"]


def test_benchmark_json_matches_the_readers():
    bench = spec.load_benchmark()
    for kind, key in (("e2e", "end_to_end"), ("metrics", "per_layer")):
        for m in bench[key]:
            mod = spec.reader(kind, m["name"])
            assert (mod.UNIT, mod.BETTER) == (m["unit"], m["better"]), m["name"]
            if kind == "metrics":
                assert mod.MOVES == m["moves"]
    for w in bench["workloads"]:
        cell = spec.resolve(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
