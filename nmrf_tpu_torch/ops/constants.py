"""Constants made on the host, kept on their device.

A forward that copies a numpy array to the card makes the host wait for
the card (a copy from pageable memory synchronises the stream), and a CUDA
graph cannot capture it.  :func:`device_constant` copies each constant
once per device and hands out the same tensor after, for the life of the
process: a captured graph reads it where it lies."""

import threading

import torch

_lock = threading.Lock()
_kept = {}


def device_constant(make, args, device, dtype=None):
    """``torch.as_tensor(make(*args), dtype, device)``, made on the first
    call with these arguments (``make`` a module-level function, ``args``
    a hashable tuple) and outside inference mode, so that a training step
    may save it for backward after a request has made it.  Read it only:
    every caller shares it.  Under a trace (``torch.export``,
    ``torch.compile``: fake tensors) it is made anew and not kept."""
    key = (make, args, torch.device(device), dtype)
    with _lock:
        t = _kept.get(key)
    if t is not None:
        return t
    with torch.inference_mode(False):
        t = torch.as_tensor(make(*args), dtype=dtype, device=device)
    if type(t) is torch.Tensor and not torch.compiler.is_compiling():
        with _lock:
            t = _kept.setdefault(key, t)
    return t
