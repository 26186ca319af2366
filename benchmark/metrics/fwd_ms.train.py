"""Device ms a step launched inside the training step's own
``nmrf::forward`` range (``solver/step.py``), the forward pass, from the
traced steps."""

RANGE = "nmrf::forward"


def read(rec):
    if "traced_steps" not in rec or not rec["trace"].device:
        return None
    return rec["trace"].split_by_ranges((RANGE,))[RANGE] / rec["traced_steps"]
