"""The program's forward convolution kernel against its roofline: over the
step's forward convolutions, the sum of max(flops / peak rate, bytes /
peak bandwidth) (x and w read once, y written once), times the steps
traced, over the device time of the operations named ``conv_mm_*``."""

import re

UNIT = "%"
BETTER = "higher"
MOVES = "images_per_s"

KERNEL = re.compile(r"(?<![A-Za-z0-9])conv_mm_\w+")


def device_s(trace) -> float:
    """Device seconds of the kernels named ``conv_mm_*``."""
    return sum(t for name, t in trace.kernel_s.items() if KERNEL.search(name))


def read(ctx):
    from perfbench.counts import bound_s

    t = device_s(ctx.trace)
    if t <= 0 or ctx.peak_flops is None or not ctx.costs.fwd:
        return None
    return 100.0 * bound_s(ctx.costs.fwd, ctx.peak_flops, ctx.peak_bytes) * ctx.trace.steps / t
