"""Registry of assigned architectures (``--arch <id>``).

Port of ``repro/configs/registry.py``, whole: ``ARCH_IDS``,
``get_config``, ``get_shape`` and the cell filters (``cell_supported``,
``all_cells``).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, mesh_split

__all__ = ["ARCH_IDS", "get_config", "get_shape", "all_cells"]

_MODULES = {
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list(_MODULES)}")
    cfg = importlib.import_module(_MODULES[arch]).CONFIG
    return cfg.reduced() if reduced else cfg


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def cell_supported(
    cfg: ArchConfig, shape: ShapeSpec, mesh_shape: tuple[int, ...] | None = None
) -> tuple[bool, str]:
    """Whether (arch × shape) is runnable; reason when skipped (DESIGN §4).

    With ``mesh_shape`` (the mesh dims, model axis last, data/pod axes
    before it) the check also covers the layout constraints, so the
    profiling campaign can drop cells that cannot be laid out at *plan*
    time instead of quarantining them one failure at a time."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode needs sub-quadratic attention"
    if mesh_shape:
        _, n_data, n_model = mesh_split(tuple(mesh_shape))
        if shape.global_batch % max(n_data, 1):
            return False, (f"batch {shape.global_batch} not divisible by "
                           f"{n_data} data-parallel devices")
        if cfg.n_kv_heads % max(n_model, 1) and cfg.d_model % max(n_model, 1):
            return False, (f"neither kv heads ({cfg.n_kv_heads}) nor d_model "
                           f"({cfg.d_model}) shard over {n_model} model devices")
    return True, ""


def all_cells() -> list[tuple[str, str, bool, str]]:
    """All 40 (arch × shape) cells with their supported/skip status."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            ok, why = cell_supported(cfg, shape)
            out.append((arch, shape_name, ok, why))
    return out
