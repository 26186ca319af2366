"""Device ms a request spends in host-device copies (``predict``'s
frames in, its disparity out: the memcpy events named HtoD or DtoH; the
model's own device-to-device copies and memsets are not counted), from
the traced requests."""

from benchmark import arith


def read(rec):
    if "traced_frames" not in rec or not rec["trace"].device:
        return None
    return rec["trace"].kernel_ms(**arith.HOST_COPY) / rec["traced_frames"]
