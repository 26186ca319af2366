"""Host ms a request spends in the program's range
``nmrf::predict.forward``: the model call, that is the host's issue of
every launch of the request, from the traced requests."""

from benchmark import spans


def read(rec):
    ms = spans.predict_phases(rec)
    return None if ms is None else ms["forward"]
