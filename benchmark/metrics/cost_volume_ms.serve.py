"""Device ms a request launched inside the program's range
``nmrf::cost_volume`` (the group-wise correlation volume), from the traced
requests."""

from benchmark import spans

RANGE = "nmrf::cost_volume"


def read(rec):
    if "traced_frames" not in rec or not rec["trace"].device \
            or not spans.ranges(rec["trace"], (RANGE,)):
        return None
    ms = rec["trace"].split_by_ranges((RANGE,))[RANGE]
    return ms / rec["traced_frames"]
