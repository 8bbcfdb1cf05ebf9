"""Γ: ``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` at its start, in 1e9 bytes."""

UNIT = "GB"
BETTER = "lower"


def read(window):
    return window.peak_bytes / 1e9 if window.peak_bytes > 0 else None
