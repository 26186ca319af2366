"""Device ms a frame launched inside the benchmark's ranges around the
Inference and Refinement stages, from the traced requests."""

RANGES = ("bench::inference", "bench::refinement")


def read(rec):
    if "traced_frames" not in rec or not rec["trace"].device:
        return None
    ms = rec["trace"].split_by_ranges(RANGES)
    return sum(ms[r] for r in RANGES) / rec["traced_frames"]
