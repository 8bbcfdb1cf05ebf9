"""jamba-v0.1-52b — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
Mamba+attention 1:7 interleave, MoE 16 experts top-2 every other layer.
[arXiv:2403.19887; hf]

Note (DESIGN §4): Jamba's mamba sublayers are Mamba-1; we implement the
Mamba-2 SSD form for all SSM mixers in this framework (the assigned
mamba2-780m fixes the SSD formulation; using it uniformly keeps one
well-tested kernel).  State size matches Jamba (16).

Port of ``repro/configs/jamba_v0_1_52b.py`` (a copy: the port imports nothing of
``repro``).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    moe_d_ff=14336,
    vocab=65536,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,              # MoE FFN on every 2nd sublayer
    hybrid_period=8,          # 1 attention mixer per 8 layers
    hybrid_attn_index=4,
    ssm_state=16,
    ssm_head_dim=64,          # d_inner = 8192 → 128 SSD heads
    ssm_expand=2,
)
