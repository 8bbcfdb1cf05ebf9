"""Device time of one step outside the forward convolution kernel and the
convolution backward: BatchNorm, activations, pooling, the loss, the
``Dense`` head and the optimiser's update, in ms a step."""

from perfbench.spec import reader

UNIT = "ms"
BETTER = "lower"
MOVES = "images_per_s"


def read(ctx):
    t = ctx.trace
    if t.steps <= 0 or t.device_s <= 0:
        return None
    conv = reader("metrics", "conv_mm.roofline_pct", ctx.root).device_s(t)
    bwd = reader("metrics", "conv_bwd.roofline_pct", ctx.root).device_s(t)
    return 1e3 * (t.device_s - conv - bwd) / t.steps
