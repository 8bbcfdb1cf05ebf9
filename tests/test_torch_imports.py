"""The PyTorch port stands alone: importing ``repro_torch`` (every module)
pulls in neither ``jax`` nor ``repro``, no source file of the port (nor
``chip_smoke.py``) imports them, and the entry points refuse to fall back
to the CPU when CUDA is absent and the caller did not ask for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k in ("jax", "repro") or k.startswith(("jax.", "repro.")))
print(len(names), bad)
"""


def test_import_leaves_jax_and_repro_out():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 30          # every module of the slice was imported
    assert bad == "[]", bad


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def _entry_points():
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import (cnn_params_from_numpy, params_from_jax,
                                     train_state_from_jax)
    from repro_torch.core.dataset import GridSpec, collect_grid
    from repro_torch.core.profiler import profile_inference, profile_training
    from repro_torch.engine import ProfilerBackend
    from repro_torch.models import transformer as T
    from repro_torch.models.cnn import build_squeezenet
    from repro_torch.serve import ContinuousEngine, ServeEngine
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.train.trainer import Trainer
    from repro_torch.campaign import CampaignCell, CampaignRunner, smoke_plan
    from repro_torch.campaign import __main__ as campaign_cli
    from repro_torch.campaign.runner import measure_cell
    from repro_torch.launch.lowering import compile_cell
    from repro_torch.bench import check_thresholds, engine_bench, kernel_bench, serve_bench
    from repro_torch.launch import dryrun

    cfg = get_config("qwen3-4b", reduced=True)
    cell = CampaignCell("qwen3-4b", ShapeSpec("t", 16, 2, "train"))
    params = T.init_params(cfg, 0, device="cpu")
    cnn = build_squeezenet(width_mult=0.125, input_hw=16)
    return {
        "profile_training": lambda: profile_training(cnn, 2),
        "profile_inference": lambda: profile_inference(cnn, 2),
        "collect_grid": lambda: collect_grid(GridSpec("squeezenet", (0.0,))),
        "ProfilerBackend": lambda: ProfilerBackend(),
        "cnn_params_from_numpy": lambda: cnn_params_from_numpy(cnn.init(0)),
        "ContinuousEngine": lambda: ContinuousEngine(cfg, params),
        "ServeEngine": lambda: ServeEngine(cfg, params),
        "init_params": lambda: T.init_params(cfg, 0),
        "init_cache": lambda: T.init_cache(cfg, 1, 16),
        "init_paged_cache": lambda: T.init_paged_cache(cfg, 3, 16),
        "params_from_jax": lambda: params_from_jax({}, cfg),
        "train_state_from_jax": lambda: train_state_from_jax({"params": {}}, cfg),
        "Trainer": lambda: Trainer(cfg, ShapeSpec("t", 16, 2, "train")),
        "TokenPipeline": lambda: TokenPipeline(cfg, ShapeSpec("t", 16, 2, "train")),
        "launch.train": lambda: launch_train.main(
            ["--arch", "qwen3-4b", "--reduced", "--steps", "1"]),
        "CampaignRunner": lambda: CampaignRunner(smoke_plan(subsample=2), "/dev/null"),
        "measure_cell": lambda: measure_cell(cell),
        "compile_cell": lambda: compile_cell(cfg, cell.shape),
        "campaign run": lambda: campaign_cli.main(
            ["run", "--plan", str(ROOT / "missing-plan.json"), "--ledger", "/dev/null"]),
        "kernel_bench.run": lambda: kernel_bench.run(lambda *_: None),
        "engine_bench.run": lambda: engine_bench.run(lambda *_: None),
        "engine_bench.calibration_accuracy": lambda: engine_bench.calibration_accuracy(
            lambda *_: None),
        "serve_bench.run": lambda: serve_bench.run(lambda *_: None),
        "serve_bench.run_chunked": lambda: serve_bench.run_chunked(lambda *_: None),
        "serve_bench.run_chaos": lambda: serve_bench.run_chaos(lambda *_: None),
        "dryrun": lambda: dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k",
                                       "--out", ""]),
        "check_thresholds.collect": lambda: check_thresholds.collect(lambda *_: None),
    }


@pytest.mark.parametrize("name", ["ContinuousEngine", "ServeEngine",
                                  "init_params", "init_cache",
                                  "init_paged_cache", "params_from_jax",
                                  "profile_training", "profile_inference",
                                  "collect_grid", "cnn_params_from_numpy",
                                  "ProfilerBackend", "train_state_from_jax",
                                  "Trainer", "TokenPipeline", "launch.train",
                                  "CampaignRunner", "measure_cell", "compile_cell",
                                  "campaign run", "kernel_bench.run",
                                  "engine_bench.run",
                                  "engine_bench.calibration_accuracy",
                                  "serve_bench.run", "serve_bench.run_chunked",
                                  "serve_bench.run_chaos", "dryrun",
                                  "check_thresholds.collect"])
def test_default_device_raises_without_cuda(monkeypatch, name):
    call = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises: CPU tensors never reach it
    silently (``ops.paged_decode_attention`` sends them to the plain
    version instead)."""
    from repro_torch.kernels.paged_decode.kernel import paged_decode_cuda

    q = torch.zeros(1, 4, 64)
    pool = torch.zeros(2, 16, 2, 64)
    bt = torch.zeros(1, 1, dtype=torch.int32)
    cl = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_decode_cuda(q, pool, pool, bt, cl)
    assert paged_decode_cuda.launches == 0


def test_conv_mm_kernel_refuses_cpu_tensors():
    """As above for the convolution kernel: ``ops.conv_mm`` sends CPU
    tensors to the plain version; the CUDA wrapper itself raises and does
    not count a launch."""
    from repro_torch.kernels.conv_mm.kernel import conv_mm_cuda

    x = torch.zeros(1, 8, 8, 4)
    w = torch.zeros(3, 3, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv_mm_cuda(x, w, stride=1, padding=1)
    assert conv_mm_cuda.launches == 0


def test_flash_attention_kernel_refuses_cpu_tensors():
    """As above for flash attention: ``ops.flash_attention`` sends CPU
    tensors to the plain version; the CUDA wrapper raises and counts no
    launch."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, q, q)
    assert flash_attention_cuda.launches == flash_attention_cuda.tuner_launches == 0


def test_ssd_chunk_kernel_refuses_cpu_tensors():
    """As above for the SSD intra-chunk pass (``ops.ssd`` sends CPU tensors
    to ``ref.ssd_chunk_ref``)."""
    from repro_torch.kernels.ssm_scan.kernel import ssd_chunk_cuda

    x = torch.zeros(1, 16, 2, 8)
    bc = torch.zeros(1, 16, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_chunk_cuda(x, torch.zeros(1, 16, 2), bc, bc, chunk=16)
    assert ssd_chunk_cuda.launches == ssd_chunk_cuda.tuner_launches == 0


def test_profiler_backend_takes_the_cpu_when_asked():
    """``ProfilerBackend(device="cpu")`` is the one way to profile without a
    card; its salt names the device."""
    from repro_torch.engine import ProfilerBackend

    assert ProfilerBackend(device="cpu").device == torch.device("cpu")
    assert ProfilerBackend(device="cpu").cache_salt().endswith(":cpu")


def test_new_modules_of_the_training_slice_are_covered():
    """The training slice's modules, named so that a rename cannot drop
    them; the probe above holds that none of them pulls in ``jax`` or
    ``repro``."""
    import importlib

    expected = {
        "repro_torch.data.pipeline": {"PipelineConfig", "TokenPipeline", "make_batch"},
        "repro_torch.optim.optimizer": {"OptimizerConfig", "init_opt_state",
                                        "apply_updates", "cosine_schedule",
                                        "global_norm", "clip_by_global_norm"},
        "repro_torch.optim.compression": {"init_error_state", "compress_grads",
                                          "compression_stats"},
        "repro_torch.train.checkpoint": {"save_checkpoint", "restore_checkpoint",
                                         "latest_step", "list_steps"},
        "repro_torch.train.trainer": {"TrainerConfig", "Trainer", "StragglerMonitor"},
        "repro_torch.launch.train": {"main"},
        "repro_torch.models.transformer": {"loss_fn"},
    }
    for name, names in expected.items():
        mod = importlib.import_module(name)
        assert all(hasattr(mod, n) for n in names), name
        assert names <= set(getattr(mod, "__all__", names)), name


def test_new_modules_of_the_engine_slice_are_covered():
    """The engine slice's modules, named as for the tuner slice below; the
    probe above holds that none of them pulls in ``jax`` or ``repro``."""
    import importlib

    import repro_torch.engine as engine

    for name in ("repro_torch.engine.types", "repro_torch.engine.cache",
                 "repro_torch.engine.decompose", "repro_torch.engine.engine",
                 "repro_torch.engine.backends", "repro_torch.engine.calibrate",
                 "repro_torch.core.search"):
        importlib.import_module(name)
    for name in ("CostQuery", "CostEstimate", "EstimateCache", "CostEngine",
                 "HealthState", "ForestBackend", "AnalyticalBackend",
                 "ProfilerBackend", "EnsembleBackend", "calibrate",
                 "default_workloads", "measure_ground_truth", "evaluate_accuracy"):
        assert name in engine.__all__ and hasattr(engine, name)
    search = importlib.import_module("repro_torch.core.search")
    assert {"Constraints", "SearchResult", "evolutionary_search"} <= set(search.__all__)


def test_new_modules_of_the_tuner_slice_are_covered():
    """The probe above imports every module; these are the ones the
    autotuner slice adds, named so that a rename cannot drop them."""
    import importlib

    for name in ("repro_torch.costmodel", "repro_torch.costmodel.ledger",
                 "repro_torch.engine", "repro_torch.engine.devices",
                 "repro_torch.kernels.flash_attention.kernel",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.ssm_scan.kernel",
                 "repro_torch.kernels.ssm_scan.ops",
                 "repro_torch.kernels.moe_dispatch.tiling"):
        importlib.import_module(name)
    sources = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.cu")}
    assert sources == {"kernels/paged_decode/csrc/paged_decode.cu",
                       "kernels/batchnorm/csrc/batchnorm.cu",
                       "kernels/conv_mm/csrc/conv_mm.cu",
                       "kernels/flash_attention/csrc/flash_attention.cu",
                       "kernels/ssm_scan/csrc/ssd_chunk.cu"}


def test_new_modules_of_the_layer_plan_slice_are_covered():
    """The MoE, SSD and cross-attention slice: the layers and the plan
    functions it adds, named so that a rename cannot drop them; the probe
    above holds that none of them pulls in ``jax`` or ``repro``."""
    import importlib

    expected = {
        "repro_torch.models.layers": {"MoE", "SSM", "moe_block", "moe_capacity",
                                      "ssd_block", "attention_block"},
        "repro_torch.models.transformer": {"layer_plan", "param_name",
                                           "cache_shapes", "input_specs",
                                           "paged_cache_shapes", "warm_autotune"},
        "repro_torch.kernels.moe_dispatch.tiling": {"shape_key", "cost"},
        "repro_torch.serve.engine": {"ServeEngine"},
    }
    for name, names in expected.items():
        mod = importlib.import_module(name)
        assert all(hasattr(mod, n) for n in names), name
        assert names <= set(getattr(mod, "__all__", names)), name
    layers = importlib.import_module("repro_torch.models.layers")
    for private in ("_moe_dispatch_group", "_moe_combine_group",
                    "_load_balance_loss", "_tuned_moe_dispatch", "_tuned_ssm_chunk"):
        assert callable(getattr(layers, private)), private


def test_new_modules_of_the_admission_slice_are_covered():
    """The cost-ledger producer, the roofline layer, serve admission and
    failover, and the grown engine, serve and launch modules, named so
    that a rename cannot drop them; the probe above holds that none of
    them pulls in ``jax`` or ``repro``."""
    import importlib

    expected = {
        "repro_torch.core.hlo_cost": {"HloCost", "trace_cost", "recording"},
        "repro_torch.core.roofline": {"RooflineReport", "roofline_from_cost",
                                      "model_flops_for_cell"},
        "repro_torch.core.profiler": {"meta_memory"},
        "repro_torch.costmodel": {"CostLedger", "OpCost", "OP_CLASSES", "classify_op"},
        "repro_torch.engine.decompose": {"price_ledger_energy", "ledger_latency_columns"},
        "repro_torch.engine": {"AnalyticalBackend", "ForestBackend", "CostEngine",
                               "from_torch_device"},
        "repro_torch.serve.scheduler": {"SLOScheduler", "PlacementRefused", "Decision",
                                        "ServeSLO"},
        "repro_torch.serve.health": {"FailoverChain", "STATIC_LEVEL"},
        "repro_torch.serve": {"SLOScheduler", "FailoverChain", "STATIC_LEVEL",
                              "ContinuousEngine", "ServeEngine"},
        "repro_torch.kernels.autotune": {"untimed"},
        "repro_torch.launch.train": {"main"},
    }
    for name, names in expected.items():
        mod = importlib.import_module(name)
        assert all(hasattr(mod, n) for n in names), name
        assert names <= set(getattr(mod, "__all__", names)), name
    backends = importlib.import_module("repro_torch.engine.backends")
    assert not hasattr(backends, "LM_FOREST_TODO")
    assert not hasattr(backends, "LM_ANALYTICAL_TODO")
    assert not hasattr(importlib.import_module("repro_torch.serve.continuous"),
                       "COST_ENGINE_TODO")


def test_kernels_package_reexports_the_tuner_api():
    """``repro_torch.kernels`` re-exports the tuner's API, the reference's
    ``__all__`` name for name (ROADMAP queue 3 item 1), and importing the
    package builds no kernel and touches no CUDA state."""
    probe = ("import sys, torch; import repro_torch.kernels as k; "
             "from repro_torch.kernels import KernelTuner; "
             "print(sorted(k.__all__), torch.cuda.is_initialized(), "
             "sorted(m for m in sys.modules if m.startswith('repro_torch.kernels.')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import repro.kernels as ref_kernels
    import repro_torch.kernels as kernels

    assert kernels.__all__ == ref_kernels.__all__
    assert all(callable(getattr(kernels, n)) for n in kernels.__all__)
    names = str(sorted(ref_kernels.__all__))
    assert out.stdout.strip() == f"{names} False ['repro_torch.kernels.autotune']"


def test_new_modules_of_the_campaign_slice_are_covered():
    """The campaign slice (queue 1 items 6 and 7a): the modules and names
    it adds, named so that a rename cannot drop them; the probe above
    holds that none of them pulls in ``jax`` or ``repro``."""
    import importlib

    from repro.campaign import __all__ as ref_campaign_all

    expected = {
        "repro_torch.campaign": set(ref_campaign_all),
        "repro_torch.campaign.plan": {"SMOKE_SHAPES", "CampaignCell", "CampaignPlan",
                                      "mesh_dims", "resolve_shape", "plan_grid",
                                      "smoke_plan", "collective_smoke_plan", "load_plan"},
        "repro_torch.campaign.lm_features": {"LM_FEATURE_NAMES", "cell_features",
                                             "feature_matrix", "query_cell"},
        "repro_torch.campaign.runner": {"CampaignLedger", "CampaignRunner", "CellTimeout",
                                        "measure_cell"},
        "repro_torch.campaign.fit": {"LMForest", "split_records", "fit_lm_forest",
                                     "check_device_fingerprints", "fit_hlo_constants",
                                     "register_lm_forest"},
        "repro_torch.campaign.__main__": {"main"},
        "repro_torch.distributed.sharding": {"param_pspecs", "batch_pspecs",
                                             "cache_pspecs", "state_pspecs",
                                             "fsdp_wanted", "LeafSharding",
                                             "describe_sharding"},
        "repro_torch.distributed.collectives": {"COLLECTIVE_CLASSES", "abstract_mesh",
                                                "LayoutCollectives",
                                                "layout_collectives"},
        "repro_torch.distributed.pipeline_parallel": {"bubble_fraction"},
        "repro_torch.launch.mesh": {"MeshSpecError", "validate_mesh_spec", "dp_axes"},
        "repro_torch.launch.lowering": {"make_train_step", "compile_cell"},
        "repro_torch.configs.base": {"SHAPES", "TRAIN_SHAPES", "DECODE_SHAPES",
                                     "mesh_split"},
        "repro_torch.configs.registry": {"get_shape", "all_cells"},
    }
    for name, names in expected.items():
        mod = importlib.import_module(name)
        assert all(hasattr(mod, n) for n in names), name
        assert names <= set(getattr(mod, "__all__", names)), name
    registry = importlib.import_module("repro_torch.configs.registry")
    assert callable(registry.cell_supported)
    launch = importlib.import_module("repro_torch.launch.train")
    assert not hasattr(launch, "_WAITS_ON")       # no launcher flag waits on an item


def test_new_modules_of_the_planner_and_bench_slice_are_covered():
    """The planner and bench slice (queue 1 items 7b and 1i): the nine
    modules it adds or changes, named so that a rename cannot drop them;
    the probe above holds that none of them pulls in ``jax`` or ``repro``."""
    import importlib

    from repro.planner import __all__ as ref_planner_all

    expected = {
        "repro_torch.planner": set(ref_planner_all),
        "repro_torch.planner.layouts": {"MeshLayout", "enumerate_layouts"},
        "repro_torch.planner.planner": {"LayoutDecision", "LayoutRefusal",
                                        "LayoutPlan", "LayoutPlanner"},
        "repro_torch.planner.__main__": {"main"},
        "repro_torch.launch.train": {"main"},
        "repro_torch.bench.engine_bench": {"run", "ledger_breakdown_parity",
                                           "calibration_accuracy", "campaign_accuracy",
                                           "planner_bench", "collective_calibration"},
        "repro_torch.bench.kernel_bench": {"run", "card_rows"},
        "repro_torch.bench.serve_bench": {"make_trace", "run_lockstep",
                                          "run_continuous", "run", "run_chaos",
                                          "run_chunked"},
        "repro_torch.bench.run": {"main", "NOT_PORTED"},
    }
    for name, names in expected.items():
        mod = importlib.import_module(name)
        assert all(hasattr(mod, n) for n in names), name
        assert names <= set(getattr(mod, "__all__", names)), name
    planner = importlib.import_module("repro_torch.planner")
    assert planner.__all__ == ref_planner_all
    bench_run = importlib.import_module("repro_torch.bench.run")
    assert set(bench_run.NOT_PORTED) == set()


def test_new_modules_of_the_sharded_execution_slice_are_covered():
    """The sharded-execution slice (queue 1 item 7c and the last benches):
    the modules and names it adds, named so that a rename cannot drop
    them; the probe above holds that none of them pulls in ``jax`` or
    ``repro``."""
    import importlib

    from repro.core.hlo_analysis import __all__ as ref_analysis_all
    from repro.distributed.pipeline_parallel import __all__ as ref_pp_all
    from repro.launch.mesh import __all__ as ref_mesh_all

    expected = {
        "repro_torch.launch.dryrun": {"main", "DEFAULT_OUT"},
        "repro_torch.launch.mesh": (set(ref_mesh_all) - {"TPU_V5E"}) | {"fake_world"},
        "repro_torch.launch.lowering": {"make_train_step", "compile_cell", "lower_cell"},
        "repro_torch.core.hlo_analysis": set(ref_analysis_all)
        | {"collective_kind", "ring_bytes", "collective_stats_from_ops"},
        "repro_torch.distributed.sharding": {"to_named", "NamedSharding",
                                             "distribute_tree", "port_params",
                                             "train_state_shardings", "placements"},
        "repro_torch.distributed.pipeline_parallel": set(ref_pp_all),
        "repro_torch.models.layers": {"hint_mesh", "sequence_parallel"},
        "repro_torch.bench.roofline_table": {"load_reports", "run", "DRYRUN_PATH"},
        "repro_torch.bench.check_thresholds": {"collect", "evaluate", "main"},
        "repro_torch.bench.engine_bench": {"collective_calibration"},
    }
    for name, names in expected.items():
        mod = importlib.import_module(name)
        assert all(hasattr(mod, n) for n in names), name
        assert names <= set(getattr(mod, "__all__", names)), name
    layers = importlib.import_module("repro_torch.models.layers")
    assert callable(layers._maybe_constrain)
    for rel in ("train/trainer.py", "launch/train.py", "launch/lowering.py",
                "launch/mesh.py", "models/layers.py", "core/hlo_cost.py",
                "distributed/__init__.py", "distributed/sharding.py",
                "distributed/pipeline_parallel.py", "bench/engine_bench.py",
                "campaign/plan.py", "planner/__init__.py"):
        text = (PORT / rel).read_text()
        assert "_MESH_TODO" not in text and "item 7c" not in text, rel


_NO_GROUP_PROBE = """
import torch.distributed as dist
import repro_torch.launch.mesh, repro_torch.launch.lowering, repro_torch.launch.dryrun
import repro_torch.core.hlo_cost, repro_torch.bench.roofline_table
print(dist.is_initialized())
"""


def test_importing_the_mesh_modules_initialises_no_process_group():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _NO_GROUP_PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
