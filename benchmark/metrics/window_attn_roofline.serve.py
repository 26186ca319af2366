"""The share of its roofline that the NMP window attention reaches in the
traced requests: the least time of the work (``arith.window_bound`` of
each call's shapes: bytes at 3.35 TB/s or bf16 operations at 989
TFLOP/s, whichever is longer) over the device ms launched inside the
benchmark's ranges around every ``WindowAttention`` module, in %."""

from benchmark import arith

RANGE = "bench::window_attention"


def read(rec):
    calls = rec.get("attn_calls")
    if not calls or not rec["trace"].device:
        return None
    ms = rec["trace"].split_by_ranges((RANGE,))[RANGE]
    return 100.0 * arith.least_ms(calls) / ms if ms > 0 else None
