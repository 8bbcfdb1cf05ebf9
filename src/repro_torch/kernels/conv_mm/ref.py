"""Plain PyTorch versions of the MM convolution (port of
``repro/kernels/conv_mm/ref.py`` and of ``_conv_body`` in
``repro/kernels/conv_mm/kernel.py``).

``ops.conv_mm`` runs ``conv_ref`` for tensors on the CPU (and on the meta
device, where the profiler counts flops); on the card the CUDA kernel
computes the same function and ``chip_smoke.py`` holds the two against
each other.  Both functions take NHWC inputs and HWIO weights, any kernel
size, stride and symmetric zero padding, groups = 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv_ref", "conv_im2col_ref", "out_hw"]


def out_hw(H: int, W: int, KH: int, KW: int, stride: int, padding: int):
    return (1 + (H + 2 * padding - KH) // stride,
            1 + (W + 2 * padding - KW) // stride)


def _acc_dtype(x) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _patches(x, KH, KW, stride, padding):
    """Yield ((kh, kw), strided window of the zero-padded x) of shape
    (N, OH, OW, C), in the kernel's (kh, kw) order."""
    N, H, W, C = x.shape
    OH, OW = out_hw(H, W, KH, KW, stride, padding)
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    for i in range(KH):
        for j in range(KW):
            yield (i, j), x[:, i:i + (OH - 1) * stride + 1:stride,
                            j:j + (OW - 1) * stride + 1:stride, :]


def conv_ref(x, w, *, stride: int = 1, padding: int = 0):
    """x: (N, H, W, C) NHWC; w: (KH, KW, C, O) HWIO → (N, OH, OW, O) in
    x's dtype: Σ_{kh,kw} patch(N·OH·OW × C) @ w[kh, kw](C × O), summed in
    f32 (f64 for f64 inputs), as ``_conv_body`` does for one image."""
    N, H, W, C = x.shape
    KH, KW, _, O = w.shape
    OH, OW = out_hw(H, W, KH, KW, stride, padding)
    acc_t = _acc_dtype(x)
    acc = torch.zeros((N * OH * OW, O), dtype=acc_t, device=x.device)
    for (i, j), patch in _patches(x, KH, KW, stride, padding):
        acc = acc + patch.reshape(N * OH * OW, C).to(acc_t) @ w[i, j].to(acc_t)
    return acc.reshape(N, OH, OW, O).to(x.dtype)


def conv_im2col_ref(x, w, *, stride: int = 1, padding: int = 0):
    """Materialised im2col + one matmul (the paper's ``mem_i2c_total``
    variant): (N, OH·OW, KH·KW·C) @ (KH·KW·C, O) in f32 (f64 for f64
    inputs), cast to x's dtype."""
    N, H, W, C = x.shape
    KH, KW, _, O = w.shape
    OH, OW = out_hw(H, W, KH, KW, stride, padding)
    cols = [p.reshape(N, OH * OW, C) for _, p in _patches(x, KH, KW, stride, padding)]
    im2col = torch.cat(cols, dim=-1)
    acc_t = _acc_dtype(x)
    y = im2col.to(acc_t) @ w.reshape(KH * KW * C, O).to(acc_t)
    return y.reshape(N, OH, OW, O).to(x.dtype)
