"""Mamba-2 SSD, chunked (port of ``repro/kernels/ssm_scan/``): the
intra-chunk pass as a hand-written CUDA kernel on the card (its plain
PyTorch version on the CPU), the inter-chunk recurrence in PyTorch.  No
model code calls it; the autotuner times it through its tiling runner."""

from repro_torch.kernels.ssm_scan.ops import ssd
from repro_torch.kernels.ssm_scan.ref import ssd_chunk_ref, ssd_naive, ssd_ref

__all__ = ["ssd", "ssd_ref", "ssd_naive", "ssd_chunk_ref"]
