"""Device resolution for the port's entry points (no counterpart in ``repro``).

Every entry point takes ``device`` (default ``"cuda"``).  Without a card
that default raises instead of quietly running on the CPU; the CPU is
used only when the caller asks for it.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
