"""Device ms a request launched inside the program's range
``nmrf::raft.encode`` (RAFT-Stereo's ``fnet`` on both images, ``cnet`` and
the context's z/r/q convolutions), from the traced requests."""

from benchmark import spans

RANGE = "nmrf::raft.encode"


def read(rec):
    if "traced_frames" not in rec or not rec["trace"].device \
            or not spans.ranges(rec["trace"], (RANGE,)):
        return None
    ms = rec["trace"].split_by_ranges((RANGE,))[RANGE]
    return ms / rec["traced_frames"]
