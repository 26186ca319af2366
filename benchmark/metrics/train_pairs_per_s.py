"""Image pairs of all training steps completed in the window over the
window's seconds (the window ends on a loss readback)."""

from benchmark import arith


def read(rec):
    if "pairs" not in rec:
        return None
    return arith.rate(rec["pairs"], rec["window_s"])
