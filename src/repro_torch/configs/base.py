"""Architecture configuration: the frozen :class:`ArchConfig`.

Port of ``repro/configs/base.py``.  This slice keeps ``ArchConfig``
whole (``reduced()``, ``padded_vocab``, ``head_dim_``, ``param_count``);
the workload shapes (``ShapeSpec``, ``SHAPES``) and ``mesh_split`` come
with the slices that use them.

``reduced()`` derives the same-family smoke-test config (small layers/width,
few experts, tiny vocab) that runs a real step on CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

__all__ = ["ArchConfig"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None      # None → d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    attn_bias: bool = False
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int | None = None      # per-expert FFN width (defaults to d_ff)
    capacity_factor: float = 1.25
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    # --- hybrid interleave (jamba): 1 attention mixer per `period` layers ---
    hybrid_period: int = 0           # 0 → not hybrid
    hybrid_attn_index: int = 4       # which sublayer in the period is attention
    moe_every: int = 0               # every Nth sublayer uses MoE FFN (jamba: 2)
    # --- attention variant ---
    attention: str = "full"          # full | chunked | none
    chunk_size: int = 8192           # local-attention window (llama4 long ctx)
    # --- modality frontends (stubs per brief) ---
    frontend: str | None = None      # vision_stub | audio_stub
    n_prefix: int = 0                # prefix embeddings (vlm patches)
    n_encoder_layers: int = 0        # enc-dec (whisper)
    n_audio_frames: int = 0          # encoder input length (whisper stub)
    # --- numerics ---
    dtype: str = "bfloat16"
    max_seq_len: int = 524_288

    # ------------------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def moe_d_ff_(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    def padded_vocab(self, multiple: int = 256) -> int:
        """Vocab rounded up so the (vocab, d) embedding shards evenly on any
        mesh axis up to ``multiple`` — standard practice (noted in DESIGN)."""
        return _round_up(self.vocab, multiple)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-token cell? (SSM/hybrid/chunked attn)"""
        return self.family in ("ssm", "hybrid") or self.attention == "chunked"

    # --- parameter counting (MODEL_FLOPS = 6·N·D needs N) ------------------

    def param_count(self, active_only: bool = False) -> int:
        D, Dh = self.d_model, self.head_dim_
        V = self.padded_vocab()
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += D * V
        per_attn = D * self.n_heads * Dh + 2 * D * self.n_kv_heads * Dh \
            + self.n_heads * Dh * D
        per_mlp = 3 * D * self.d_ff  # SwiGLU
        e_count = self.experts_per_token if active_only else self.n_experts
        per_moe = D * self.n_experts + 3 * D * self.moe_d_ff_ * max(e_count, 1)
        d_inner = self.ssm_expand * D
        ssm_heads = d_inner // self.ssm_head_dim if self.ssm_state else 0
        per_ssm = (
            D * (2 * d_inner + 2 * self.ssm_state + ssm_heads)  # in_proj
            + self.ssm_conv_width * (d_inner + 2 * self.ssm_state)
            + d_inner * D                                        # out_proj
            + 2 * ssm_heads                                      # A_log, D
        ) if self.ssm_state else 0

        if self.family == "ssm":
            n += self.n_layers * (per_ssm + 2 * D)
        elif self.hybrid_period:
            n_attn = self.n_layers // self.hybrid_period
            n_ssm = self.n_layers - n_attn
            n_moe = self.n_layers // self.moe_every if self.moe_every else 0
            n_mlp = self.n_layers - n_moe
            n += n_attn * per_attn + n_ssm * per_ssm + n_moe * per_moe \
                + n_mlp * per_mlp + self.n_layers * 2 * D
        elif self.is_moe:
            n += self.n_layers * (per_attn + per_moe + 2 * D)
        else:
            n += self.n_layers * (per_attn + per_mlp + 2 * D)
        if self.n_encoder_layers:
            n += self.n_encoder_layers * (per_attn + per_mlp + 2 * D)
            n += self.n_layers * per_attn  # decoder cross-attention
        return int(n)

    # --- smoke-scale config -------------------------------------------------

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, self.hybrid_period or 2),
            d_model=128,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=32,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=128 if self.is_moe else None,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=32,
            chunk_size=64,
            n_prefix=8 if self.n_prefix else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            n_audio_frames=16 if self.n_audio_frames else 0,
            max_seq_len=256,
        )
