"""qwen3-moe-30b-a3b — 48L d_model=2048 32H (GQA kv=4) moe_d_ff=768
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]

Port of ``repro/configs/qwen3_moe_30b_a3b.py`` (a copy: the port imports nothing of
``repro``).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    moe_d_ff=768,
    vocab=151936,
    qk_norm=True,
    n_experts=128,
    experts_per_token=8,
    attention="full",
    rope_theta=1e6,
)
