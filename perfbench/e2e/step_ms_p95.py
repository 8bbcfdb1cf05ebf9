"""The 95th percentile (linear between ranks) of the window's step times,
each the device time between CUDA events recorded at consecutive step
boundaries."""

import numpy as np

UNIT = "ms"
BETTER = "lower"


def read(window):
    return float(np.percentile(window.step_ms, 95)) if window.step_ms else None
