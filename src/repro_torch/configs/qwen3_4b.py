"""qwen3-4b — 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936,
qk_norm.  [hf:Qwen/Qwen3-8B; hf]

Port of ``repro/configs/qwen3_4b.py`` (a copy: the port imports nothing of
``repro``).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
)
