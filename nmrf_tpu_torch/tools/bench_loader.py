"""Host data-pipeline throughput of the port: threaded against process-pool
loading (``tools/bench_loader.py``).

    python -m nmrf_tpu_torch.tools.bench_loader [--size 64] [--batch 8]
        [--workers N] [--height 384] [--width 768] [--no-aug] [--device cuda]

The synthetic random-dot set through the training augmentor
(``data/transforms.py:FlowAugmentor``: the photometric chain in the host
C++ kernel, the spatial transforms in numpy) at half the set's size as the
crop, batched by ``PrefetchLoader`` with threads, then with a spawn
process pool (``DATALOADER.USE_PROCESSES``), each batch moved to the
device through ``parallel.device_prefetch`` as the training CLI moves it.
The synthetic draws are pure numpy: real PNG/PFM decoding costs more a
sample, so the process pool gains more there.  Prints samples/s and ms a
sample for each, then the ratio.
"""

import argparse
import os
import time

import numpy as np


class AugmentedSynthetic:
    """Synthetic samples through the training augmentor: the host work of a
    training sample without file reads."""

    def __init__(self, base, crop):
        from ..data.transforms import FlowAugmentor

        self.base = base
        self.aug = FlowAugmentor(crop_size=crop)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        s = self.base[i]
        flow = np.stack([s["disp"], np.zeros_like(s["disp"])], axis=-1)
        img1, img2, flow = self.aug(
            s["img1"].astype(np.uint8), s["img2"].astype(np.uint8), flow)
        disp = flow[..., 0].astype(np.float32)
        return {"img1": img1.astype(np.float32),
                "img2": img2.astype(np.float32),
                "disp": disp, "valid": disp < 512}


def run(ds, sampler, workers, use_processes, device, label):
    """samples/s of one epoch after its first batch (which starts the
    workers), each batch on ``device``."""
    from ..data import PrefetchLoader
    from ..parallel import device_prefetch
    from ..utils.benchmarks import sync

    loader = PrefetchLoader(ds, sampler, num_workers=workers,
                            use_processes=use_processes)
    try:
        it = iter(device_prefetch(loader, device=device, size=1))
        next(it)
        t0 = time.perf_counter()
        n = 0
        for batch in it:
            n += batch["img1"].shape[0]
        sync(device)
        dt = time.perf_counter() - t0
        print(f"{label:>10}: {n / dt:8.1f} samples/s "
              f"({dt / max(n, 1) * 1e3:.1f} ms/sample)", flush=True)
        return n / dt
    finally:
        loader.shutdown()


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--workers", type=int, default=os.cpu_count())
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--no-aug", action="store_true",
                   help="raw synthetic generation only (numpy-bound)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None):
    """Returns {"threads", "processes"}: samples/s."""
    from ..data import ShardedBatchSampler, SyntheticStereoDataset
    from ..models import resolve_device

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    ds = SyntheticStereoDataset(size=args.size, height=args.height,
                                width=args.width)
    if not args.no_aug:
        ds = AugmentedSynthetic(ds, (args.height // 2, args.width // 2))
    sampler = ShardedBatchSampler(len(ds), args.batch, seed=0)
    print(f"{args.size} samples @ {args.height}x{args.width}"
          f"{' +augmentor' if not args.no_aug else ''}, batch {args.batch}, "
          f"{args.workers} workers, {os.cpu_count()} cores, to {device}")
    t = run(ds, sampler, args.workers, False, device, "threads")
    p = run(ds, sampler, args.workers, True, device, "processes")
    print(f"process/thread speedup: {p / t:.2f}x")
    return {"threads": t, "processes": p}


if __name__ == "__main__":
    main()
