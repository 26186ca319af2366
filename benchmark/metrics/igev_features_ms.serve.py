"""Device ms a request launched inside the program's range
``nmrf::igev.features`` (IGEV-Stereo's input normalisation, MobileNetV2
trunk and decoder, stems and matching features, both images), from the
traced requests."""

from benchmark import spans

RANGE = "nmrf::igev.features"


def read(rec):
    if "traced_frames" not in rec or not rec["trace"].device \
            or not spans.ranges(rec["trace"], (RANGE,)):
        return None
    ms = rec["trace"].split_by_ranges((RANGE,))[RANGE]
    return ms / rec["traced_frames"]
