"""Matrix-multiplication 2-D convolution, NHWC × HWIO, groups 1 (port of
``repro/kernels/conv_mm/``): a hand-written implicit-GEMM CUDA kernel on
the card, its plain PyTorch version on the CPU."""

from repro_torch.kernels.conv_mm.ops import conv_mm
from repro_torch.kernels.conv_mm.ref import conv_im2col_ref, conv_ref

__all__ = ["conv_mm", "conv_ref", "conv_im2col_ref"]
