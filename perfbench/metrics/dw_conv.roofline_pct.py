"""The depthwise convolutions against their roofline: over every pass of
the step's grouped convolutions (forward, and in training dgrad and
wgrad), the sum of max(flops / peak rate, bytes / peak bandwidth), times
the steps traced, over the device time under the program's spans
``repro.dw_conv`` (the forward) and ``repro.dw_conv.backward`` (its
gradients).  A program without those spans reads None."""

UNIT = "%"
BETTER = "higher"
MOVES = "images_per_s"

SPANS = ("repro.dw_conv", "repro.dw_conv.backward")


def device_s(trace) -> float | None:
    """Device seconds under the spans, or None if the trace has neither."""
    found = [t for t in map(trace.under, SPANS) if t is not None]
    return sum(found) if found else None


def read(ctx):
    from perfbench.counts import bound_s

    t = device_s(ctx.trace)
    if not t or ctx.peak_flops is None or not ctx.costs.dw:
        return None
    return 100.0 * bound_s(ctx.costs.dw, ctx.peak_flops, ctx.peak_bytes) * ctx.trace.steps / t
