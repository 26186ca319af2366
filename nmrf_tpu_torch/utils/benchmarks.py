"""Timing and set-up helpers of the measurement entry points
(``nmrf_tpu/utils/benchmarks.py``; ``bench.py``, ``bench_train.py`` and
``tools/`` build on them, so the methodology lives in one place).

Chained calls: each call takes its first argument perturbed by a zero token
derived from the previous call's output.  On one CUDA stream the calls run
in issue order anyway; the token keeps the data dependency of the JAX
package's chains (each call consumes its predecessor's result), so the two
packages time the same work, one reduction and one add more a call.

Times are CUDA-event milliseconds of a window of back-to-back calls; the
host's wall clock over the same window is offered beside them, because the
port's eager forward is host-bound (the host issues 1,500-2,000 launches a
frame) and the two then differ.  On the CPU (``--device cpu``, for the
tests) both are wall time.
"""

import subprocess
import time

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..data.frame_io import InputPadder

KITTI_HW = (375, 1242)  # KITTI 2015, the serving benchmark's frame


def gpu_identity():
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_identity(device):
    """``gpu_identity()`` on a card; on the CPU a line saying so."""
    if torch.device(device).type == "cuda":
        return gpu_identity()
    return "cpu (plain PyTorch versions; no device metric)"


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """Device and wall milliseconds of the work issued inside a ``with``
    block: CUDA events on a card, the host clock around a final sync
    everywhere.  ``ms`` and ``wall_ms`` are set when the block exits."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.ms = self.wall_ms = None

    def __enter__(self):
        if self.device.type == "cuda":
            self._events = [torch.cuda.Event(enable_timing=True)
                            for _ in range(2)]
            self._events[0].record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self._events[1].record()
        sync(self.device)
        self.wall_ms = (time.perf_counter() - self._t0) * 1e3
        self.ms = (self._events[0].elapsed_time(self._events[1])
                   if self.device.type == "cuda" else self.wall_ms)
        return False


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    return next(t for t in (_first_tensor(o) for o in out) if t is not None)


def zero_token(out):
    """A float32 zero that depends on ``out`` (its first tensor's mean)."""
    return _first_tensor(out).float().mean() * 0.0


def perturb(x, token):
    """``x`` (a tensor or a nested list or tuple of tensors) with the token
    added to every floating tensor."""
    return tree_map(lambda t: t + token.to(t.dtype)
                    if isinstance(t, torch.Tensor) and t.is_floating_point()
                    else t, x)


def chain(fn, args, iters):
    """``iters`` calls of ``fn(*args)`` back to back, each on the first
    argument perturbed by the previous output's zero token; returns the last
    token."""
    token = torch.zeros((), device=_first_tensor(args).device)
    for _ in range(iters):
        token = zero_token(fn(perturb(args[0], token), *args[1:]))
    return token


def chained_ms(fn, *args, iters=20, wall=False):
    """Steady-state per-call latency of ``fn(*args)`` in milliseconds: one
    warm-up call, then ``iters`` chained calls (:func:`chain`) in one
    :class:`Window`.  ``fn`` must accept its first argument (a tensor or a
    nested list of tensors) perturbed by a zero token and return tensors.
    Returns the device ms a call, or with ``wall`` (device ms, wall ms)."""
    device = _first_tensor(args).device
    with torch.inference_mode():
        chain(fn, args, 1)
        sync(device)
        with Window(device) as w:
            chain(fn, args, iters)
    return (w.ms / iters, w.wall_ms / iters) if wall else w.ms / iters


def kitti_inputs(cfg, device, hw=KITTI_HW, seed=0):
    """The benchmark's image pair: ``hw`` random frames (numpy
    ``RandomState(seed)``, 0..255) padded by ``InputPadder`` in
    ``proposal`` mode to ``DATASETS.DIVIS_BY``, as [1, Hp, Wp, 3] float32
    tensors on ``device``."""
    H, W = hw
    padder = InputPadder((H, W), mode="proposal",
                         divis_by=cfg.DATASETS.DIVIS_BY)
    rng = np.random.RandomState(seed)
    imgs = [padder.pad((rng.rand(H, W, 3) * 255).astype(np.float32))[0]
            for _ in range(2)]
    return [torch.from_numpy(np.ascontiguousarray(i[None])).to(device)
            for i in imgs]


def parse_hw(text):
    """``"375x1242"`` -> (375, 1242)."""
    H, W = (int(v) for v in text.lower().split("x"))
    return H, W
