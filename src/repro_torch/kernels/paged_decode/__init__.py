"""Decode-specialised paged attention (port of
``repro/kernels/paged_decode/``): one query token per slot attends over
that slot's KV history, read in place from the block pool through a
per-slot ``block_table``."""

from repro_torch.kernels.paged_decode.ops import paged_decode_attention
from repro_torch.kernels.paged_decode.ref import paged_decode_ref

__all__ = ["paged_decode_attention", "paged_decode_ref"]
