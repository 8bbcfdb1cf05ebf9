"""Host time of one call of the program's forward convolution wrapper
(the ``repro.conv_mm`` span: its checks, the tile rule, the output's
allocation and the launch) in µs, with the profiler on: the median over
the traced steps' calls, so that the calls whose launch waited for room
in the device's queue do not set it.  Read only from a trace that saw
the device (on the CPU the span holds the plain convolution itself), and
only from a program that keeps its spans' host durations."""

from perfbench.spans import program_host_s

UNIT = "us"
BETTER = "lower"
MOVES = "images_per_s"

SPAN = "repro.conv_mm"


def read(ctx):
    import statistics

    ts = program_host_s(SPAN)
    if not ts or ctx.trace.busy_s <= 0:
        return None
    return 1e6 * statistics.median(ts)
