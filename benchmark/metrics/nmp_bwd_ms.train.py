"""Device ms a step of the backward's kernels whose autograd node was
made inside the program's ranges ``nmrf::inference`` and
``nmrf::refinement`` (the NMP stages with their projections and
decodes), attributed by ``spans.backward_ms``, from the traced steps."""

from benchmark import spans

STAGES = ("nmrf::inference", "nmrf::refinement")


def read(rec):
    ms = spans.backward_per_step(rec)
    return None if ms is None else sum(ms[s] for s in STAGES)
