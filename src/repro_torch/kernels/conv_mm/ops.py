"""Public wrapper for the MM convolution (port of
``repro/kernels/conv_mm/ops.py``).

The device of the tensors picks the forward path: a CUDA tensor goes to
the Hopper kernel (``kernel.conv_mm_cuda``), which launches or raises; a
CPU or meta tensor goes to the plain version (``ref.conv_ref``).  There is
no other switch: the reference's ``interpret=`` has no counterpart, and
``block_o`` is accepted for its signature but sets no tile (the CUDA
kernel's tile is fixed; the autotuner comes with a later slice).

Gradients.  The reference's Pallas kernel has no gradient (no
``custom_vjp``, no backward kernel): its CNN takes convolution gradients
from XLA, outside any Pallas kernel.  So the backward of
:func:`conv_mm` is PyTorch's convolution backward
(``aten.convolution_backward``, cuDNN on the card) on NCHW/OIHW views of
the NHWC/HWIO tensors, with TF32 off so that the gradients stay f32.
"""

from __future__ import annotations

import contextlib

import torch

from .kernel import conv_mm_cuda
from .ref import conv_ref

__all__ = ["conv_mm", "conv_backward", "fp32_convolutions"]


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN convolutions in full f32 inside the block (PyTorch lets them
    use TF32 by default); the previous setting is restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def conv_backward(gy, x, w, *, stride: int, padding: int, groups: int = 1,
                  needs=(True, True)):
    """(dx, dw) of y = conv(x, w) for NHWC x and gy and HWIO w (HWIO with
    C/groups inputs), or None where ``needs`` says the grad is not wanted.

    On the card the NHWC tensors go in as channels-last NCHW views, the
    layout cuDNN prefers.  On the CPU every operand is copied to a plain
    contiguous NCHW/OIHW tensor first: the CPU convolution backward
    corrupts the heap on some channels-last operands."""
    gy, x, w = gy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if gy.device.type == "cpu":
        gy, x = gy.contiguous(), x.contiguous()
    with fp32_convolutions():
        dx, dw, _ = torch.ops.aten.convolution_backward(
            gy, x, w.contiguous(), None, [stride, stride],
            [padding, padding], [1, 1], False, [0, 0], groups,
            [bool(needs[0]), bool(needs[1]), False])
    return (dx.permute(0, 2, 3, 1) if dx is not None else None,
            dw.permute(2, 3, 1, 0) if dw is not None else None)


def _forward(x, w, stride, padding):
    if x.device.type == "cuda":
        return conv_mm_cuda(x.contiguous(), w.contiguous(), stride=stride,
                            padding=padding)
    if x.device.type in ("cpu", "meta"):
        return conv_ref(x, w, stride=stride, padding=padding)
    raise ValueError(f"conv_mm: unsupported device {x.device}")


class _ConvMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return _forward(x, w, stride, padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        dx, dw = conv_backward(gy, x, w, stride=ctx.stride,
                               padding=ctx.padding,
                               needs=ctx.needs_input_grad[:2])
        return dx, dw, None, None


def conv_mm(x, w, *, stride: int = 1, padding: int = 0, block_o=None):
    """x: (N, H, W, C) NHWC; w: (KH, KW, C, O) HWIO → (N, OH, OW, O) in
    x's dtype, differentiable in x and w."""
    return _ConvMM.apply(x, w, int(stride), int(padding))
