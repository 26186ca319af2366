"""Device ms a step of the backward's kernels whose autograd node was
made inside the program's ranges ``nmrf::cost_volume`` and ``nmrf::dpn``
(the correlation volume, the DPN's filter, NMS and propagation),
attributed by ``spans.backward_ms``, from the traced steps."""

from benchmark import spans

STAGES = ("nmrf::cost_volume", "nmrf::dpn")


def read(rec):
    ms = spans.backward_per_step(rec)
    return None if ms is None else sum(ms[s] for s in STAGES)
