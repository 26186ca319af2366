"""Training throughput of the port: ms a step, frames/s and MFU of the full
training step (forward, backward, gradient clip and AdamW) on the card
(root ``bench_train.py``).

    python -m nmrf_tpu_torch.bench_train [--config-file FILE]
        [--peak-tflops 989] [--device cuda] [KEY VALUE ...]
    torchrun --nproc-per-node N -m nmrf_tpu_torch.bench_train ...

The config's defaults are the production recipe (crop 384x768, batch 8;
add ``TPU.COMPUTE_DTYPE bfloat16`` for the deployed dtype).  The batch is
synthetic, from numpy ``RandomState(0)`` as the JAX bench draws it; the
weights random from ``cfg.SEED``.  One warm-up step, then 10 timed steps
closed by reading the loss back; ``NMRF_FUSED_POS=1`` in the environment
takes B7 for the window backward, as in training.  Under ``torchrun``
(world above 1) the ranks form the ``TPU.MESH_DATA`` x ``TPU.MESH_SPATIAL``
grid as ``python -m nmrf_tpu_torch.train`` does and each takes its part of
the one global batch.

Stdout is one JSON line with the JAX bench's keys: ``metric``
(``train_step_{H}x{W}_b{B}`` plus ``_<config stem>``), ``value`` (ms a
step, wall), ``unit``, ``frames_per_s``, ``total_loss``, ``tflops_per_step``
(``tools/flops.py``'s count of the step on the plain path, every layer,
over the world: one card's share, as the JAX bench's count of one device's
partitioned step is) and ``mfu`` of one card against ``--peak-tflops``
(the H100 SXM's dense bf16 989 by default).  The JAX bench's optional ``hbm_gb_per_step`` and ``mbu`` are not
printed: the backward kernels launch inside autograd functions, where no
dispatch-level byte count sees them.  Stderr has the CUDA-event ms, the
launches a step, whether deterministic algorithms are on (they are left
off: they cost 38% of the step on the H100, and the JAX package has no such
switch), and the card's name and power limit.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ITERS = 10


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--peak-tflops", type=float, default=989.0,
                   help="the card's dense bf16 peak (H100 SXM: 989)")
    p.add_argument("--config-file", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def _log(msg):
    print(f"bench_train: {msg}", file=sys.stderr, flush=True)


def synthetic_batch(B, H, W, seed=0):
    """The JAX bench's batch: images and disparities uniform from numpy
    ``RandomState(seed)``, every pixel valid."""
    rng = np.random.RandomState(seed)
    return {"img1": (rng.rand(B, H, W, 3) * 255).astype(np.float32),
            "img2": (rng.rand(B, H, W, 3) * 255).astype(np.float32),
            "disp": (rng.rand(B, H, W) * 100).astype(np.float32),
            "valid": np.ones((B, H, W), bool)}


def main(argv=None):
    """Run the bench; prints the JSON line and returns {"record": its dict,
    "device_ms": CUDA-event ms a step (wall on the CPU), "launches": the
    timed steps' kernel launches, "flops": the whole step's count (the
    global batch), "card"}."""
    from .models import resolve_device

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    own_group = world > 1 and not dist.is_initialized()
    if own_group:  # torchrun's env:// rendezvous
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        return _run(args, device, world)
    finally:
        if own_group:
            dist.destroy_process_group()


def _run(args, device, world):
    from .config import get_cfg
    from .models import build_criterion, build_model
    from .ops import _native
    from .parallel import make_mesh, shard_batch
    from .solver import build_optimizer, make_train_step
    from .tools import flops
    from .utils.benchmarks import Window, device_identity

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    B = cfg.SOLVER.IMS_PER_BATCH
    H, W = cfg.DATASETS.CROP_SIZE

    mesh = None
    if world > 1:
        mesh = make_mesh(cfg.TPU.MESH_DATA, cfg.TPU.MESH_SPATIAL,
                         device="cpu" if device.type == "cpu" else None)
        device = mesh.device
    model = build_model(cfg, device=device, mesh=mesh)
    optimizer, scheduler = build_optimizer(model, cfg)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg.SOLVER.ACCUM_STEPS,
                           grad_clip=cfg.SOLVER.GRAD_CLIP, mesh=mesh)
    batch = synthetic_batch(B, H, W)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    else:
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    # the step's FLOPs on the plain path (every layer, no remat)
    count_cfg = cfg.clone()
    count_cfg.defrost()
    count_cfg.TPU.USE_PALLAS = False
    count_cfg.TPU.MSDA_TAP_RADIUS = 0
    count_cfg.TPU.REMAT = False
    count_cfg.freeze()
    step_flops = flops.train_step_flops(count_cfg, B, device)["flops_per_step"]
    rank_flops = step_flops / world

    card = device_identity(device)
    _log(f"{card}; deterministic algorithms "
         f"{'on' if torch.are_deterministic_algorithms_enabled() else 'off'}, "
         f"cudnn.deterministic {torch.backends.cudnn.deterministic}; "
         f"NMRF_FUSED_POS={os.environ.get('NMRF_FUSED_POS', '')!r}; "
         f"{'mesh ' + str((mesh.data, mesh.spatial)) if mesh else 'one device'}")
    losses = step(batch)
    _log(f"warmup total: {float(losses['total'])}")

    _native.reset_launch_counts()
    with Window(device) as w:
        for _ in range(ITERS):
            losses = step(batch)
        total = float(losses["total"])  # the readback closes the window
    launches = _native.launch_counts()
    dt = w.wall_ms / ITERS / 1e3
    _log(f"{ITERS} steps: wall {w.wall_ms / ITERS:.3f} ms/step, "
         f"{'CUDA events' if device.type == 'cuda' else 'cpu'} "
         f"{w.ms / ITERS:.3f} ms/step; launches a step "
         + json.dumps({k: v / ITERS for k, v in launches.items() if v}))
    step_mfu = flops.mfu(rank_flops, dt * 1e3, args.peak_tflops)
    _log("flops " + json.dumps({"step_flops": step_flops, "world": world,
                                "flops_per_rank": rank_flops,
                                "wall_ms": dt * 1e3, "mfu": step_mfu}))
    _log("hbm_gb_per_step and mbu are not reported: the backward kernels "
         "launch inside autograd functions, where no dispatch-level byte "
         "count sees them")

    variant = ""
    if args.config_file:
        variant = "_" + os.path.splitext(os.path.basename(args.config_file))[0]
    record = {
        "metric": f"train_step_{H}x{W}_b{B}{variant}",
        "value": round(dt * 1000.0, 2),
        "unit": "ms/step",
        "frames_per_s": round(B / dt, 2),
        "total_loss": round(total, 3),
        "tflops_per_step": round(rank_flops / 1e12, 2),
        "mfu": round(step_mfu, 4),
    }
    if mesh is None or mesh.rank == 0:
        print(json.dumps(record), flush=True)
    return {"record": record, "device_ms": w.ms / ITERS, "launches": launches,
            "flops": step_flops, "card": card}


if __name__ == "__main__":
    main()
