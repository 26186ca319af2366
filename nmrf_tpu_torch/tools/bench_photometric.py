"""PIL against the host C++ photometric kernel, ms a sample at the training
crop (``tools/bench_photometric.py``).

    python -m nmrf_tpu_torch.tools.bench_photometric [--height 384]
        [--width 768] [--iters 50] [--device cuda]

The chain is the per-sample colour transform of both augmentors
(ColorJitter's four ops in a random order, then AdjustGamma) over the
stacked pair [2H, W, 3] that ``FlowAugmentor.color_transform`` passes it:
its PIL version, then ``data/transforms.py:fused_photometric`` in
``native/photometric.cpp``, with the same draws.  Host work only: the
device is resolved as every entry point resolves it and not used.
"""

import argparse
import random
import time

import numpy as np


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None):
    """Returns {"pil", "native"}: ms a sample."""
    from .. import native
    from ..data import transforms as T
    from ..models import resolve_device

    args = _parser().parse_args(argv)
    resolve_device(args.device)
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 256, (2 * args.height, args.width, 3), dtype=np.uint8)
    jitter = T.ColorJitter(0.4, 0.4, (0.6, 1.4), 0.5 / 3.14)
    gamma = T.AdjustGamma(0.8, 1.2)
    native.load()  # builds the kernel: its first call is not timed

    out = {}
    for name, plain in (("pil", True), ("native", False)):
        def once(i):
            random.seed(i)
            return T.fused_photometric(arr, jitter, gamma, plain=plain)

        once(0)  # warm-up: imports, caches
        t0 = time.perf_counter()
        for i in range(args.iters):
            once(i)
        out[name] = (time.perf_counter() - t0) / args.iters * 1e3
        print(f"{name}: {out[name]:.2f} ms/sample", flush=True)
    return out


if __name__ == "__main__":
    main()
