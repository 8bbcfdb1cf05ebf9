"""The convolution backward (dgrad and wgrad, cuDNN today) against its
roofline: over the step's backward passes, the sum of max(flops / peak
rate, bytes / peak bandwidth) (dgrad: gy and w read, dx written; wgrad: gy
and x read, dw written; no dgrad for the stem), times the steps traced,
over the device time under the host operator
``aten::convolution_backward``."""

UNIT = "%"
BETTER = "higher"
MOVES = "images_per_s"

OP = "aten::convolution_backward"


def device_s(trace) -> float:
    return trace.under(OP) or 0.0


def read(ctx):
    from perfbench.counts import bound_s

    t = device_s(ctx.trace)
    if t <= 0 or ctx.peak_flops is None or not ctx.costs.bwd:
        return None
    return 100.0 * bound_s(ctx.costs.bwd, ctx.peak_flops, ctx.peak_bytes) * ctx.trace.steps / t
