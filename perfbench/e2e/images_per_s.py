"""Images of all steps completed in the window over the window's
host-clock seconds (the window ends with a synchronize after the last
step)."""

UNIT = "images/s"
BETTER = "higher"


def read(window):
    return window.items / window.seconds if window.seconds > 0 else None
