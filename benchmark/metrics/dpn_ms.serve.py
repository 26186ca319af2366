"""Device ms a frame launched inside the benchmark's range around
the DPN (cost-volume filter, NMS, propagation), from the traced requests."""

RANGES = ("bench::dpn",)


def read(rec):
    if "traced_frames" not in rec or not rec["trace"].device:
        return None
    ms = rec["trace"].split_by_ranges(RANGES)
    return sum(ms[r] for r in RANGES) / rec["traced_frames"]
