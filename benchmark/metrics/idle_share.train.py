"""The device's idle share of the traced stretch: 1 - the union of the
device intervals over the traced window, in %."""


def read(rec):
    if "trace" not in rec or not rec["trace"].device:
        return None
    return 100.0 * rec["trace"].idle_share()
