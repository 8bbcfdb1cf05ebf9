"""whisper-tiny — enc-dec, 4L encoder + 4L decoder, d_model=384 6H d_ff=1536
vocab=51865; conv audio frontend is a STUB (input_specs provides frame
embeddings).  [arXiv:2212.04356; unverified]

Port of ``repro/configs/whisper_tiny.py`` (a copy: the port imports nothing of
``repro``).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,               # decoder layers
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    frontend="audio_stub",
    n_audio_frames=1500,      # 30 s of audio after the conv frontend
    attn_bias=True,
    tie_embeddings=True,
)
