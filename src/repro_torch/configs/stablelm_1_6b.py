"""stablelm-1.6b — 24L d_model=2048 32H (kv=32 ⇒ MHA) d_ff=5632
vocab=100352.  [hf:stabilityai/stablelm-2-1_6b; unverified]

Port of ``repro/configs/stablelm_1_6b.py`` (a copy: the port imports nothing of
``repro``).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab=100352,
    rope_theta=1e4,
)
