"""The share of its roofline that IGEV-Stereo's volume stage reaches in the
traced requests: the stage's least time at the served padded size
(``arith_igev.volume_least_ms``: bytes at 3.35 TB/s or bf16 FLOPs at 989
TFLOP/s, whichever is longer) over the device ms a request launched inside
the program's range ``nmrf::igev.volume``, in %."""

from benchmark import arith_igev, spans

RANGE = "nmrf::igev.volume"


def read(rec):
    shape = rec.get("igev_volume")
    if not shape or "traced_frames" not in rec or not rec["trace"].device \
            or not spans.ranges(rec["trace"], (RANGE,)):
        return None
    ms = rec["trace"].split_by_ranges((RANGE,))[RANGE] / rec["traced_frames"]
    least = arith_igev.volume_least_ms(**shape)[0]
    return 100.0 * least / ms if ms > 0 else None
