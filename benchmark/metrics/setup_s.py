"""Set-up seconds: from the process's start to the first timed request or
step (loading, weights, building the kernels in a cold checkout, the
warm-up)."""


def read(rec):
    return rec["setup_s"]
