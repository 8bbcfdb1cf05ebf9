"""mamba2-780m — 48L d_model=1536, attention-free SSD (state-space duality),
ssm_state=128, vocab=50280.  [arXiv:2405.21060; unverified]

Port of ``repro/configs/mamba2_780m.py`` (a copy: the port imports nothing of
``repro``).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,            # no attention heads (attn-free)
    n_kv_heads=1,
    d_ff=0,               # SSD blocks replace MLPs (mamba2 has no FFN)
    vocab=50280,
    attention="none",
    ssm_state=128,
    ssm_head_dim=64,      # d_inner = 2*1536 = 3072 → 48 SSD heads
    ssm_expand=2,
    tie_embeddings=True,
)
