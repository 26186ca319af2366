"""The share of its roofline that the window attention's backward (K1b)
reaches in the traced steps: the least time of the backward work
(``arith.window_bound(..., backward=True)`` of each forward call's
shapes) over the device ms of the kernels named here, in %."""

from benchmark import arith

# the CUDA functions of the backward (csrc/window_attention_bwd.cu)
KERNELS = ("window_bwd_mma_kernel", "window_attention_bwd_kernel",
           "window_dve_")


def read(rec):
    calls = rec.get("attn_calls")
    if not calls or not rec["trace"].device:
        return None
    ms = rec["trace"].kernel_ms(KERNELS)
    return 100.0 * arith.least_ms(calls, backward=True) / ms if ms > 0 \
        else None
