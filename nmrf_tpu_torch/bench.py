"""KITTI-resolution stereo latency of the port on one card (root
``bench.py``).

    python -m nmrf_tpu_torch.bench [--repeat N] [--config-file FILE]
        [--profile-dir DIR] [--device cuda] [KEY VALUE ...]

Upstream NMRF reports 90 ms a frame at 1242x375 on an RTX 3090
(``BASELINE.md``).  This times the full forward (resnet backbone by
default; ``--config-file configs/sceneflow_swint.yaml`` for swin) at that
frame, padded by ``InputPadder`` in proposal mode to ``DATASETS.DIVIS_BY``,
in bf16 with the tanh GELU (``TPU.COMPUTE_DTYPE``/``TPU.GELU_APPROX``
override them), random weights from ``cfg.SEED``, the inputs from numpy
``RandomState(0)`` on the device.  ``BENCH_HW HxW`` changes the frame.

A chain is K = 16 forwards back to back under ``inference_mode``, each on
its input perturbed by the previous output's zero token
(``utils/benchmarks.py``), closed by one sync; the value is the host's
wall ms of a chain over K: the eager forward is host-bound, so that is
the latency a caller sees.  ``--repeat N`` times N chains and reports their
mean, the spread on stderr.  Stdout is ONE JSON line with the JAX bench's
keys: ``metric`` (``kitti_1242x375_latency`` plus ``_<config stem>``),
``value``, ``unit`` (ms/frame), ``vs_baseline`` (90 / value).

Stderr also carries the CUDA-event ms a frame beside the wall ms, the
deployed forward's FLOPs (``FlopCounterMode`` with the kernels' formulas)
beside the plain path's, the bytes at its op boundaries
(``tools/flops.py:BoundaryBytes``), the kernel launches of the timed
chains, and the card's name and power limit.  ``--profile-dir`` profiles
one more chain after the timed ones and prints its summary by kernel
(``tools/profile_model.py``); the trace is ``DIR/trace.json``.
"""

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

BASELINE_MS = 90.0
K = 16


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repeat", type=int, default=1,
                   help="time N chains; mean on stdout, spread on stderr")
    p.add_argument("--config-file", default="")
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def _log(msg):
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def bench_cfg(config_file="", opts=(), use_kernels=None):
    """The benchmarked configuration: bf16 and the tanh GELU, then the
    overrides; ``use_kernels`` False gives the same forward's plain path."""
    from .config import get_cfg

    cfg = get_cfg()
    if config_file:
        cfg.merge_from_file(config_file)
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.GELU_APPROX = True
    cfg.merge_from_list(list(opts))
    if use_kernels is not None:
        cfg.TPU.USE_PALLAS = use_kernels
    cfg.freeze()
    return cfg


def main(argv=None):
    """Run the bench; prints the JSON line and returns {"record": that line's
    dict, "wall_ms" and "device_ms": per-chain ms a frame, "launches": the
    timed chains' kernel launches, "deployed_flops", "plain_flops",
    "flops_by_op", "bytes", "bytes_by_op", "card", "profile": the trace
    summary or None}."""
    from .models import build_model, resolve_device
    from .ops import attention
    from .tools import flops
    from .tools.profile_model import print_summary, profile, summarize_trace
    from .utils.benchmarks import (KITTI_HW, Window, chain, device_identity,
                                   kitti_inputs, parse_hw, sync)

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = bench_cfg(args.config_file, args.opts)
    hw = parse_hw(os.environ["BENCH_HW"]) if os.environ.get("BENCH_HW") \
        else KITTI_HW
    card = device_identity(device)
    model = build_model(cfg, device=device)
    img1, img2 = kitti_inputs(cfg, device, hw)
    inputs = (img1, img2)

    def forward(a, b):
        return model(a, b)["disp"]

    with torch.inference_mode():
        chain(forward, inputs, 2)  # warm-up: first launches, allocator
        sync(device)
    deployed, by_op = flops.forward_flops(model, img1, img2, by_op=True)
    plain_model = build_model(bench_cfg(args.config_file, args.opts, False),
                              device=device)
    plain = flops.forward_flops(plain_model, img1, img2)
    del plain_model
    nbytes, bytes_by_op = flops.forward_bytes(model, img1, img2)
    _log(f"frame {hw[0]}x{hw[1]} padded to {img1.shape[1]}x{img1.shape[2]}, "
         f"{card}")
    _log(f"deployed per-frame flops {deployed / 1e9:.3f} GFLOP (plain path "
         f"{plain / 1e9:.3f}; the kernels' operators "
         + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in by_op.items()
                     if k.startswith("nmrf.")) + f"), bytes at op boundaries "
         f"{nbytes / 1e9:.3f} GB")

    attention.reset_launch_counts()
    wall, dev = [], []
    with torch.inference_mode():
        for _ in range(args.repeat):
            with Window(device) as w:
                chain(forward, inputs, K)
            wall.append(w.wall_ms / K)
            dev.append(w.ms / K)
    launches = attention.launch_counts()
    ms = float(np.mean(wall))
    _log(f"{args.repeat} chains of {K}: wall ms/frame mean {ms:.3f} min "
         f"{min(wall):.3f} max {max(wall):.3f} samples "
         f"{[round(s, 3) for s in wall]}; "
         f"{'device (CUDA events)' if device.type == 'cuda' else 'cpu'} "
         f"ms/frame mean {np.mean(dev):.3f} samples {[round(s, 3) for s in dev]}")
    _log(f"launches in the timed chains {json.dumps(launches)}")

    summary = None
    if args.profile_dir:
        with torch.inference_mode():
            path = profile(lambda: chain(forward, inputs, K),
                           os.path.join(args.profile_dir, "trace.json"), device)
        summary = summarize_trace(path)
        with contextlib.redirect_stdout(sys.stderr):
            print_summary(summary, K, "ms/frame", f"trace {path}, {K} frames: ")

    variant = ""
    if args.config_file:
        variant = "_" + os.path.splitext(os.path.basename(args.config_file))[0]
    record = {"metric": "kitti_1242x375_latency" + variant,
              "value": round(ms, 3), "unit": "ms/frame",
              "vs_baseline": round(BASELINE_MS / ms, 3)}
    print(json.dumps(record), flush=True)
    return {"record": record, "wall_ms": wall, "device_ms": dev,
            "launches": launches, "deployed_flops": deployed,
            "plain_flops": plain, "flops_by_op": by_op, "bytes": nbytes,
            "bytes_by_op": bytes_by_op, "card": card, "profile": summary}


if __name__ == "__main__":
    main()
