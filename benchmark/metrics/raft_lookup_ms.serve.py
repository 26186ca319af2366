"""Device ms a request launched inside the program's ranges
``nmrf::raft.lookup`` (RAFT-Stereo's correlation lookup, one range an
iteration, inside ``nmrf::raft.update``), from the traced requests."""

from benchmark import spans

RANGE = "nmrf::raft.lookup"


def read(rec):
    if "traced_frames" not in rec or not rec["trace"].device \
            or not spans.ranges(rec["trace"], (RANGE,)):
        return None
    ms = rec["trace"].split_by_ranges((RANGE,))[RANGE]
    return ms / rec["traced_frames"]
