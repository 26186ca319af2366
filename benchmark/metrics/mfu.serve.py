"""Model FLOPs utilisation of serving: the FLOPs of one request (counted
on the plain reference, 2 a multiply-add) times the window's requests a
second, over the H100's dense bf16 peak of 989 TFLOP/s, in %."""

from benchmark import arith


def read(rec):
    if "flops_per_unit" not in rec or not rec["trace"].device:
        return None
    rate = arith.rate(rec["completed"], rec["window_s"])
    return 100.0 * rec["flops_per_unit"] * rate / arith.BF16_OPS_PER_S
