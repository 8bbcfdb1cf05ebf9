"""Blockwise flash attention, forward only (port of
``repro/kernels/flash_attention/``): a hand-written CUDA kernel on the
card, its plain PyTorch version on the CPU.  No model code calls it; the
autotuner times it through its tiling runner (``tiling._runner``), and
``blocked_attention`` shares its tiling model for ``block_q``."""

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "attention_ref"]
