"""Kernel-launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``, on any
thread, the autograd engine's included) a step inside the program's range
``nmrf::step``, from the traced steps."""

from benchmark import spans


def read(rec):
    if "traced_steps" not in rec or not rec["trace"].device:
        return None
    n = spans.launches(rec["trace"], "nmrf::step")
    return None if n is None else n / rec["traced_steps"]
