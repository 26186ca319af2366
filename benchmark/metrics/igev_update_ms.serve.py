"""Device ms a request launched inside the program's range
``nmrf::igev.update`` (IGEV-Stereo's update iterations: each combined
lookup, the motion encoder, the three GRUs and both heads; a CUDA graph's
kernels count in the range of its ``cudaGraphLaunch``), from the traced
requests."""

from benchmark import spans

RANGE = "nmrf::igev.update"


def read(rec):
    if "traced_frames" not in rec or not rec["trace"].device \
            or not spans.ranges(rec["trace"], (RANGE,)):
        return None
    ms = rec["trace"].split_by_ranges((RANGE,))[RANGE]
    return ms / rec["traced_frames"]
