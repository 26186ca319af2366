"""Host ms a request spends in ``predict``'s own work around the model,
the program's ranges ``nmrf::predict.prep`` (the float32 cast and the
pad), ``nmrf::predict.copy_in`` (both frames to the device) and
``nmrf::predict.copy_out`` (the disparity to the host, the unpad), from
the traced requests."""

from benchmark import spans

PHASES = ("prep", "copy_in", "copy_out")


def read(rec):
    ms = spans.predict_phases(rec)
    return None if ms is None else sum(ms[p] for p in PHASES)
