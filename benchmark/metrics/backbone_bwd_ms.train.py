"""Device ms a step of the backward's kernels whose autograd node was
made inside the program's range ``nmrf::backbone`` (the resnet, or Swin-T
and its neck), attributed by ``spans.backward_ms``, from the traced
steps."""

from benchmark import spans

STAGES = ("nmrf::backbone",)


def read(rec):
    ms = spans.backward_per_step(rec)
    return None if ms is None else sum(ms[s] for s in STAGES)
