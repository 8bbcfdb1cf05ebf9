"""Registry of assigned architectures (``--arch <id>``).

Port of ``repro/configs/registry.py``: ``ARCH_IDS`` and ``get_config``.
The cell filters (``cell_supported``, ``all_cells``) come with the
campaign slice.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

__all__ = ["ARCH_IDS", "get_config"]

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
