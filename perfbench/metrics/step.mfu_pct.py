"""The whole step's share of the chip's peak: the benchmark's flops of one
step (convolutions and ``Dense``; forward, and in training dgrad and
wgrad, with no dgrad for the stem) times the steps traced, over the traced
window's seconds, over the peak rate of the configuration's type (f32:
the dense TF32 rate, which an f32 product on the card does not exceed)."""

UNIT = "%"
BETTER = "higher"
MOVES = "images_per_s"


def read(ctx):
    if ctx.peak_flops is None or ctx.trace.window_s <= 0 or ctx.trace.steps <= 0:
        return None
    return 100.0 * ctx.costs.step_flops * ctx.trace.steps / ctx.trace.window_s / ctx.peak_flops
