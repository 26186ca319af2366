"""Device ms a request launched inside the program's ranges
``nmrf::igev.lookup`` (IGEV-Stereo's combined lookup of the geometry
encoding volume and the all-pairs volume, one range an iteration, inside
``nmrf::igev.update``), from the traced requests."""

from benchmark import spans

RANGE = "nmrf::igev.lookup"


def read(rec):
    if "traced_frames" not in rec or not rec["trace"].device \
            or not spans.ranges(rec["trace"], (RANGE,)):
        return None
    ms = rec["trace"].split_by_ranges((RANGE,))[RANGE]
    return ms / rec["traced_frames"]
