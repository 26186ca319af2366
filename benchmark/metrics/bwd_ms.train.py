"""Device ms a step launched inside the training step's own
``nmrf::backward`` range (``solver/step.py``), the backward pass, from the
traced steps."""

RANGE = "nmrf::backward"


def read(rec):
    if "traced_steps" not in rec or not rec["trace"].device:
        return None
    return rec["trace"].split_by_ranges((RANGE,))[RANGE] / rec["traced_steps"]
