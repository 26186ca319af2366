"""Requests completed over the whole window's seconds."""

from benchmark import arith


def read(rec):
    if "latencies_ms" not in rec:
        return None
    return arith.rate(rec["completed"], rec["window_s"])
