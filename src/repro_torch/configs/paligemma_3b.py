"""paligemma-3b — 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216;
SigLIP vision frontend is a STUB (input_specs provides patch embeddings).
[arXiv:2407.07726; hf]

Port of ``repro/configs/paligemma_3b.py`` (a copy: the port imports nothing of
``repro``).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    frontend="vision_stub",
    n_prefix=256,             # 16x16 SigLIP patches at 224px
    tie_embeddings=True,
    rope_theta=1e4,
)
