"""The port's auto-sharding planner (``repro_torch.planner``) against the
reference's (``repro.planner``), and the launcher's ``--auto-mesh``.

Everything the planner computes is framework-free arithmetic over the
configs, the sharding rules and a base estimate, so it is held exactly:

* ``enumerate_layouts`` for n = 1…64 and 256, with and without
  ``max_pipe``, and ``MeshLayout``'s parse, descriptor and ``to_dict``;
* ``LayoutPlan.to_dict()`` and ``table()`` for the 10 architectures ×
  {``train_4k``, a smoke shape, ``prefill_32k``} × {1, 2, 8, 16, 256}
  devices × {``tpu_v5e``, ``host_cpu``, ``tx2_like``}, on a pinned base and
  through a planted-forest ``CostEngine``;
* the CLI's ``plan`` and ``explain`` output and exit codes;
* no trace: the analytical backend's trace is trapped while the planner
  prices a forest-answered base.

Then the launcher on ``--torch-device cpu --reduced``: ``--auto-mesh 2``
(more devices than the host has) and ``--auto-mesh 1`` train with the
unflagged run's losses, an empty plan raises before any parameter is
drawn, a layout of as many devices as the job has ranks is built and
trained on, and the admission ``info`` carries the chosen layout.
"""

import json

import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import ShapeSpec as RefShape
from repro.engine import CostEngine as RefEngine
from repro.engine import ForestBackend as RefForest
from repro.engine import get_device as ref_device
from repro.planner import LayoutPlanner as RefPlanner
from repro.planner import MeshLayout as RefLayout
from repro.planner import enumerate_layouts as ref_enumerate
from repro.planner.__main__ import main as ref_cli
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.engine import AnalyticalBackend, CostEngine, ForestBackend, get_device
from repro_torch.launch import train as launch
from repro_torch.models import transformer as T
from repro_torch.planner import LayoutPlanner, MeshLayout, enumerate_layouts
from repro_torch.planner.__main__ import main as port_cli
from tests._torch_host import port_host_share  # noqa: F401 (autouse)

DEVICE_COUNTS = (1, 2, 8, 16, 256)
SPECS = ("tpu_v5e", "host_cpu", "tx2_like")
# (shape name, reduced): the production train cell and a prefill cell on
# the full configs, and a smoke shape on the reduced ones
SHAPE_CASES = (("train_4k", False), ("smoke_train_32x4", True), ("prefill_32k", False))
BASE = {"phi_ms": 120.0, "gamma_mb": 9000.0, "energy_j": 18.0, "source": "pinned"}


def _layout_tuple(lay):
    return (lay.pipe, lay.data, lay.model, lay.descriptor, lay.mesh_shape,
            lay.mesh_axes, lay.n_devices, lay.to_dict())


@pytest.mark.parametrize("max_pipe", [None, 1, 2, 4])
def test_enumerate_layouts_as_reference(max_pipe):
    for n in list(range(1, 65)) + [256]:
        mine = enumerate_layouts(n, max_pipe=max_pipe)
        ref = ref_enumerate(n, max_pipe=max_pipe)
        assert [_layout_tuple(m) for m in mine] == [_layout_tuple(r) for r in ref], n
        assert mine == sorted(mine)


def test_layout_parse_and_errors_as_reference():
    for desc in ("2x4x8", "4x8", "1x16x16", "1x1x1"):
        assert _layout_tuple(MeshLayout.parse(desc)) == _layout_tuple(RefLayout.parse(desc))
    for bad in ("2x4x8x16", "nope", "0x1x1", "1x-2x1"):
        with pytest.raises(ValueError) as mine:
            MeshLayout.parse(bad)
        with pytest.raises(ValueError) as ref:
            RefLayout.parse(bad)
        assert str(mine.value) == str(ref.value)
    for n in (0, -1, 2.0):
        with pytest.raises(ValueError):
            enumerate_layouts(n)


class _Planted:
    """Fitted-forest stand-in (constant Γ, Φ) for either package's
    ``ForestBackend``: the same duck type the reference's tests use."""

    fitted = True
    meta: dict = {}

    def __init__(self, device, gamma_mb=40_000.0, phi_ms=1000.0):
        self.gamma_mb, self.phi_ms = gamma_mb, phi_ms
        self.default_device = device

    def content_hash(self):
        return f"planted-{self.gamma_mb}-{self.phi_ms}"

    def predict_queries(self, queries):
        n = len(queries)
        return (np.full(n, self.gamma_mb), np.full(n, self.phi_ms))


def _plans(arch, shape_name, reduced, n, spec, engine: bool):
    if engine:
        mine = LayoutPlanner(CostEngine(ForestBackend(lm=_Planted(get_device(spec))),
                                        device=get_device(spec)), reduced=reduced)
        ref = RefPlanner(RefEngine(RefForest(lm=_Planted(ref_device(spec))),
                                   device=ref_device(spec)), reduced=reduced)
    else:
        mine = LayoutPlanner(device=spec, reduced=reduced, base=BASE)
        ref = RefPlanner(device=spec, reduced=reduced, base=BASE)
    return (mine.plan(arch, shape_name, n, n_micro=8),
            ref.plan(arch, shape_name, n, n_micro=8))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plans_equal_the_reference_over_the_grid(arch):
    """``to_dict()`` and ``table()`` of every plan equal the reference's,
    on a pinned base and through a planted-forest engine."""
    n_ranked = 0
    for shape_name, reduced in SHAPE_CASES:
        for spec in SPECS:
            for n in DEVICE_COUNTS:
                for engine in (False, True):
                    mine, ref = _plans(arch, shape_name, reduced, n, spec, engine)
                    where = (shape_name, spec, n, engine)
                    assert mine.to_dict() == ref.to_dict(), where
                    assert mine.table(top=None) == ref.table(top=None), where
                    assert mine.table() == ref.table(), where
                    n_ranked += len(mine.ranked)
    assert n_ranked > 0


def test_plan_with_max_pipe_memory_check_off_and_cfg_as_reference():
    from repro.configs.registry import get_config as ref_config
    from repro_torch.configs.registry import get_config

    shape, ref_shape = ShapeSpec("t4", 16, 4, "train"), RefShape("t4", 16, 4, "train")
    for kw in ({"max_pipe": 1}, {"max_pipe": 2, "n_micro": 4},
               {"check_memory": False}):
        mine = LayoutPlanner(device="tx2_like", reduced=True, base=dict(BASE, gamma_mb=1e7))
        ref = RefPlanner(device="tx2_like", reduced=True, base=dict(BASE, gamma_mb=1e7))
        a = mine.plan("qwen3-4b", shape, 8, cfg=get_config("qwen3-4b", reduced=True), **kw)
        b = ref.plan("qwen3-4b", ref_shape, 8, cfg=ref_config("qwen3-4b", reduced=True), **kw)
        assert a.to_dict() == b.to_dict() and a.table() == b.table(), kw
    assert REF_SHAPES["train_4k"].global_batch == 256


def test_planner_traces_nothing(monkeypatch):
    """The whole plan — the base query through the engine, every layout
    priced — with the analytical backend's trace trapped."""
    def boom(*a, **k):
        raise AssertionError("planner pricing traced a step")

    monkeypatch.setattr(AnalyticalBackend, "_trace_arch", boom)
    monkeypatch.setattr(AnalyticalBackend, "_trace_step", boom)
    engine = CostEngine(ForestBackend(lm=_Planted(get_device("host_cpu"))),
                        device=get_device("tpu_v5e"))
    plan = LayoutPlanner(engine, reduced=True).plan(
        "qwen3-4b", ShapeSpec("t4", 16, 4, "train"), 16)
    assert plan.chosen is not None and plan.meta["n_ranked"] > 1
    assert plan.base["source"] == "forest"


def test_planner_bench_rows_equal_the_reference(capsys):
    """``bench.engine_bench.planner_bench`` prints the reference's rows
    (the wall clock apart) and counts zero traces."""
    from benchmarks import engine_bench as ref_bench
    from repro_torch.bench import engine_bench

    mine_lines, ref_lines = [], []
    mine = engine_bench.planner_bench(mine_lines.append)
    ref = ref_bench.planner_bench(ref_lines.append)
    assert mine["compiles"] == ref["compiles"] == 0
    for k in ("layouts", "chosen", "chosen_phi_ms", "default_phi_ms", "speedup"):
        assert mine[k] == ref[k], k
    drop_wall = [ln for ln in mine_lines if "pricing_wall_ms" not in ln]
    assert drop_wall == [ln for ln in ref_lines if "pricing_wall_ms" not in ln]
    assert [ln.split(",")[0] for ln in mine_lines] == [ln.split(",")[0] for ln in ref_lines]


CLI_BASE = ["--arch", "qwen3-4b", "--device", "host_cpu", "--reduced",
            "--base-phi-ms", "100", "--base-gamma-mb", "100",
            "--base-energy-j", "1", "--seq", "16", "--batch", "4"]


@pytest.mark.parametrize("argv, rc", [
    (["plan", "--devices", "4"] + CLI_BASE, 0),
    (["plan", "--devices", "16", "--top", "3"] + CLI_BASE, 0),
    (["plan", "--devices", "8", "--json", "--max-pipe", "2"] + CLI_BASE, 0),
    (["plan", "--devices", "4", "--shape", "train_4k", "--device", "tx2_like",
      "--base-phi-ms", "100", "--base-gamma-mb", "1e9", "--arch", "qwen3-4b"], 4),
    (["plan", "--devices", "4", "--shape", "train_4k", "--device", "tx2_like",
      "--base-phi-ms", "100", "--base-gamma-mb", "1e9", "--arch", "qwen3-4b",
      "--no-memory-check"], 0),
    (["explain", "--devices", "4", "--layout", "1x2x2"] + CLI_BASE, 0),
    (["explain", "--devices", "4", "--layout", "4x1x1"] + CLI_BASE, 0),
    (["explain", "--devices", "4", "--layout", "1x2x4"] + CLI_BASE, 2),
    (["explain", "--devices", "4", "--layout", "2x1x2", "--max-pipe", "1"] + CLI_BASE, 2),
])
def test_cli_prints_and_exits_as_reference(capsys, argv, rc):
    assert ref_cli(argv) == rc
    ref = capsys.readouterr().out
    assert port_cli(argv) == rc
    assert capsys.readouterr().out == ref
    assert ref.strip()


def test_cli_writes_the_plan(tmp_path, capsys):
    argv = ["plan", "--devices", "8", "--out"]
    assert port_cli(argv + [str(tmp_path / "p.json")] + CLI_BASE) == 0
    assert ref_cli(argv + [str(tmp_path / "r.json")] + CLI_BASE) == 0
    capsys.readouterr()
    assert (json.loads((tmp_path / "p.json").read_text())
            == json.loads((tmp_path / "r.json").read_text()))


# ---------------------------------------------------------------------------
# the launcher's --auto-mesh
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "2", "--batch", "2",
          "--seq", "16", "--torch-device", "cpu"]


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


@pytest.fixture(scope="module")
def unflagged():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_AUTOTUNE", "0")
        return launch.main(LAUNCH)


@pytest.mark.parametrize("n, line", [
    (2, "auto-mesh: 1x1x2 needs 2 devices, host has 1 — plan reported, "
        "training unsharded"),
    (1, "auto-mesh: 1x1x1 is one device — training unsharded"),
])
def test_auto_mesh_trains_unsharded_with_the_same_losses(pinned, capsys, unflagged,
                                                         n, line):
    out = launch.main(LAUNCH + ["--auto-mesh", str(n), "--n-micro", "4"])
    text = capsys.readouterr().out
    assert f"plan internlm2-1.8b × cli on {n}× host_cpu" in text
    assert "phi_ms" in text and line in text.splitlines()
    assert out["first_loss"] == unflagged["first_loss"]
    assert out["last_loss"] == unflagged["last_loss"]
    assert out["steps"] == unflagged["steps"] == 2


def test_auto_mesh_empty_plan_raises_before_any_draw(pinned, monkeypatch, capsys,
                                                     tmp_path):
    from repro_torch.engine import DeviceSpec, save_device_spec

    path = str(tmp_path / "tiny.json")
    save_device_spec(path, DeviceSpec(name="tiny", peak_flops=1e12, hbm_bw=1e11,
                                      ici_bw=1e9, hbm_bytes=1e3))
    draws = []
    monkeypatch.setattr(T, "init_params", lambda *a, **k: draws.append(1))
    with pytest.raises(RuntimeError, match="auto-mesh: no runnable layout of 2 devices") as e:
        launch.main(LAUNCH + ["--auto-mesh", "2", "--device", path])
    assert "1x1x2: predicted" in str(e.value) and "1x2x1: predicted" in str(e.value)
    assert "refused 2:" in capsys.readouterr().out
    assert not draws


def test_auto_mesh_over_visible_devices_names_item_7c(pinned, monkeypatch, capsys):
    """A layout of as many devices as the job has ranks is built
    (``_build_mesh``: the process group and ``make_mesh``) and trained on:
    the Trainer gets the mesh; cards beyond the ranks do not count."""
    draws, seen = [], {}
    monkeypatch.setattr(T, "init_params", lambda *a, **k: draws.append(1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    mesh = object()

    def build(chosen, torch_device):
        seen["layout"], seen["device"] = chosen.descriptor, torch_device.type
        return mesh

    class Recording:
        def __init__(self, cfg, shape, opt, tcfg, *, admission, device, mesh=None):
            seen["mesh"] = mesh

        def train(self, n):
            return {"history": [], "stragglers": []}

    monkeypatch.setattr(launch, "_build_mesh", build)
    monkeypatch.setattr(launch, "Trainer", Recording)
    launch.main(LAUNCH + ["--auto-mesh", "2"])
    out = capsys.readouterr().out
    assert "needs 2 devices, host has 1 — plan reported, training unsharded" in out
    assert "mesh" in seen and seen["mesh"] is None and "layout" not in seen
    monkeypatch.setattr(launch, "_world", lambda: 2)
    launch.main(LAUNCH + ["--auto-mesh", "2"])
    out = capsys.readouterr().out
    assert "phi_ms" in out and f"auto-mesh: built {seen['layout']}" in out
    assert seen["mesh"] is mesh and seen["device"] == "cpu" and not draws


def test_auto_mesh_admission_info_carries_the_layout(pinned, monkeypatch, capsys):
    seen = {}

    class Recording:
        def __init__(self, cfg, shape, opt, tcfg, *, admission, device):
            seen["admission"] = admission(cfg, shape)

        def train(self, n):
            return {"history": [], "stragglers": []}

    monkeypatch.setattr(launch, "Trainer", Recording)
    launch.main(LAUNCH + ["--auto-mesh", "2", "--device", "tpu_v5e"])
    ok, info = seen["admission"]
    capsys.readouterr()
    assert ok and info["device"] == "tpu_v5e"
    am = info["auto_mesh"]
    assert am["layout"] in ("1x1x2", "1x2x1")
    assert set(am) == {"layout", "phi_ms", "gamma_mb", "energy_j"}
    assert am["phi_ms"] > 0 and am["gamma_mb"] > 0
    # without --auto-mesh the info has no layout
    launch.main(LAUNCH + ["--device", "tpu_v5e"])
    assert "auto_mesh" not in seen["admission"][1]
    capsys.readouterr()
