"""A ``torch.profiler`` trace of the production-recipe training step,
summarised by device kernel and split into forward, loss, backward and
optimizer (``tools/profile_train.py``).

    python -m nmrf_tpu_torch.tools.profile_train [--steps 2] [--out DIR]
        [--top 44] [--config-file FILE] [--device cuda] [KEY VALUE ...]

The recipe: crop 384x768, batch 8, bf16 (the overrides come after it);
the batch is the convergence gate's synthetic scene of step 1.  After a
warm-up step it profiles ``--steps`` steps and writes ``DIR/trace.json``.
The split reads the ``record_function`` ranges of the step
(``solver/step.py``: ``nmrf::forward``, ``nmrf::loss``, ``nmrf::backward``,
``nmrf::optimizer``) with ``profile_model.split_by_ranges``.
"""

import argparse
import os
import tempfile
import time

RANGES = ("nmrf::forward", "nmrf::loss", "nmrf::backward", "nmrf::optimizer")


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "nmrf_train_profile"))
    p.add_argument("--top", type=int, default=44)
    p.add_argument("--config-file", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def main(argv=None):
    """Profile and print; returns {"summary": ``summarize_trace``'s,
    "split_ms": device ms a step by range, "wall_ms": ms a step, "trace"}."""
    import math

    import torch

    from ..config import get_cfg
    from ..models import build_criterion, build_model, resolve_device
    from ..solver import build_optimizer, make_train_step
    from .convergence_gate import make_batch
    from .profile_model import (print_summary, profile, split_by_ranges,
                                summarize_trace)

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.DATASETS.CROP_SIZE = (384, 768)
    cfg.SOLVER.IMS_PER_BATCH = 8
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.merge_from_list(args.opts)
    cfg.freeze()

    model = build_model(cfg, device=device)
    optimizer, scheduler = build_optimizer(model, cfg)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg.SOLVER.ACCUM_STEPS,
                           grad_clip=cfg.SOLVER.GRAD_CLIP)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in make_batch(cfg, 1, 48).items()}
    float(step(batch)["total"])  # warm-up

    losses, wall = {}, None

    def steps():
        nonlocal losses, wall
        t0 = time.perf_counter()
        for _ in range(args.steps):
            losses = step(batch)
        float(losses["total"])
        wall = (time.perf_counter() - t0) / args.steps * 1e3

    path = profile(steps, os.path.join(args.out, "trace.json"), device)
    if not math.isfinite(float(losses["total"])):
        raise RuntimeError(f"non-finite loss {float(losses['total'])}")
    summary = summarize_trace(path, args.top)
    split = {k: v / args.steps
             for k, v in split_by_ranges(path, RANGES).items()}
    print_summary(summary, args.steps, "ms/step",
                  f"trace {path}, {args.steps} steps, wall {wall:.1f} ms/step "
                  f"(profiled): ")
    print("# by part (device ms/step): " + "  ".join(
        f"{k}={v:.3f}" for k, v in split.items()))
    return {"summary": summary, "split_ms": split, "wall_ms": wall,
            "trace": path}


if __name__ == "__main__":
    main()
