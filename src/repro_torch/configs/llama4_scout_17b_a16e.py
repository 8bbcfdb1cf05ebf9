"""llama4-scout-17b-a16e — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1, chunked (iRoPE-style) local attention
enabling long context.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Port of ``repro/configs/llama4_scout_17b_a16e.py`` (a copy: the port imports nothing of
``repro``).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    moe_d_ff=8192,
    vocab=202048,
    n_experts=16,
    experts_per_token=1,
    attention="chunked",      # TPU-idiomatic analogue of iRoPE chunking
    chunk_size=8192,
    rope_theta=5e5,
)
