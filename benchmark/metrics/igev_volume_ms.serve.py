"""Device ms a request launched inside the program's range
``nmrf::igev.volume`` (IGEV-Stereo's geometry encoding volume: the
group-wise correlation volume, the 3-D hourglass with its feature gates,
the classifier and the soft-argmin), from the traced requests."""

from benchmark import spans

RANGE = "nmrf::igev.volume"


def read(rec):
    if "traced_frames" not in rec or not rec["trace"].device \
            or not spans.ranges(rec["trace"], (RANGE,)):
        return None
    ms = rec["trace"].split_by_ranges((RANGE,))[RANGE]
    return ms / rec["traced_frames"]
