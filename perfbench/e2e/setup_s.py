"""Seconds from the process's start to the first timed step: imports,
loading (or, in a fresh checkout, building) the program's kernels, the
inputs and the warm-up steps."""

UNIT = "s"
BETTER = "lower"


def read(window):
    return window.setup_s
