"""Model FLOPs utilisation of training: the FLOPs of one step's forward,
loss and backward (counted on the plain reference, 2 a multiply-add)
times the window's steps a second, over the H100's dense bf16 peak of
989 TFLOP/s, in %."""

from benchmark import arith


def read(rec):
    if "flops_per_unit" not in rec or not rec["trace"].device:
        return None
    rate = arith.rate(rec["steps"], rec["window_s"])
    return 100.0 * rec["flops_per_unit"] * rate / arith.BF16_OPS_PER_S
