"""Kernel-launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``, on any
thread) a request inside the program's range ``nmrf::predict``, from the
traced requests."""

from benchmark import spans


def read(rec):
    if "traced_frames" not in rec or not rec["trace"].device:
        return None
    n = spans.launches(rec["trace"], "nmrf::predict")
    return None if n is None else n / rec["traced_frames"]
