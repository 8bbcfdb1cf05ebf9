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
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import cnn_params_from_numpy, params_from_jax
    from repro_torch.core.dataset import GridSpec, collect_grid
    from repro_torch.core.profiler import profile_inference, profile_training
    from repro_torch.engine import ProfilerBackend
    from repro_torch.models import transformer as T
    from repro_torch.models.cnn import build_squeezenet
    from repro_torch.serve import ContinuousEngine, ServeEngine

    cfg = get_config("qwen3-4b", reduced=True)
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
    }


@pytest.mark.parametrize("name", ["ContinuousEngine", "ServeEngine",
                                  "init_params", "init_cache",
                                  "init_paged_cache", "params_from_jax",
                                  "profile_training", "profile_inference",
                                  "collect_grid", "cnn_params_from_numpy",
                                  "ProfilerBackend"])
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
                       "kernels/conv_mm/csrc/conv_mm.cu",
                       "kernels/flash_attention/csrc/flash_attention.cu",
                       "kernels/ssm_scan/csrc/ssd_chunk.cu"}
