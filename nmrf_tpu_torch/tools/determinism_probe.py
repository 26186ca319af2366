"""Which operations of a training step give other bits on a second run
from the same state, with and without ``utils.misc.deterministic``.

    python -m nmrf_tpu_torch.tools.determinism_probe
    python -m nmrf_tpu_torch.tools.determinism_probe --config-file \\
        configs/sceneflow_swint.yaml

For each setting it runs one forward and backward of the training step
twice from the same weights and batch (bf16, crop 384x768, batch 8,
synthetic pairs) and compares, bit for bit, every module's output in
execution order, the gradient reaching every module's output in backward
order, and every parameter's gradient; then it times ``--steps`` training
steps with CUDA events, and again with each part of the settings alone.
Each comparison uses a checksum of the bit pattern (equal bits give equal
sums).  Prints one JSON object with the
first modules that differ, the counts and the step times, with the card's
name and power limit.
"""

import argparse
import json
import sys

import torch


def _bits(t):
    """Two checksums of a tensor's bit pattern (plain and position-
    weighted, so a permutation shows too), as Python ints."""
    t = t.detach().contiguous()
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}.get(t.dtype)
    if view is None:
        x = t.to(torch.int64).reshape(-1)
    else:
        x = t.view(view).to(torch.int64).reshape(-1)
    w = torch.arange(1, x.numel() + 1, device=x.device, dtype=torch.int64) % 65521
    return int(x.sum()), int((x * w).sum())


def _probe_pass(model, criterion, batch, state):
    """Forward and backward once from ``state``; the checksums of every
    leaf module's outputs, of the gradients reaching them and of every
    parameter's gradient."""
    model.load_state_dict(state)
    model.zero_grad(set_to_none=True)
    model.train()
    fwd, bwd, handles = [], [], []

    def hook(name):
        def fn(_module, _args, out):
            outs = out if isinstance(out, (tuple, list)) else [out]
            for j, o in enumerate(outs):
                if torch.is_tensor(o) and o.is_floating_point():
                    fwd.append((f"{name}[{j}]", _bits(o)))
                    if o.requires_grad:
                        o.register_hook(lambda g, key=f"{name}[{j}]":
                                        bwd.append((key, _bits(g))))
        return fn

    for name, m in model.named_modules():
        if not list(m.children()):
            handles.append(m.register_forward_hook(hook(name)))
    try:
        if hasattr(model, "drop_path_masks"):
            model.drop_path_masks.generator.manual_seed(0)
        out = model(batch["img1"], batch["img2"])
        losses = criterion(out, batch)
        losses["total"].backward()
    finally:
        for h in handles:
            h.remove()
    grads = [(n, _bits(p.grad)) for n, p in model.named_parameters()
             if p.grad is not None]
    return fwd, bwd, grads, _bits(losses["total"])


def _differ(a, b):
    keys = [ka for (ka, va), (kb, vb) in zip(a, b) if ka != kb or va != vb]
    return {"count": len(keys), "of": len(a), "first": keys[:8]}


def step_ms(cfg, steps):
    """CUDA-event time of a training step (after one warm-up step)."""
    from ..data import synthetic_batch
    from ..models import build_criterion, build_model
    from ..solver import build_optimizer, make_train_step

    model = build_model(cfg)
    optimizer, scheduler = build_optimizer(model, cfg)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg.SOLVER.ACCUM_STEPS,
                           grad_clip=cfg.SOLVER.GRAD_CLIP)
    B = cfg.SOLVER.IMS_PER_BATCH
    H, W = cfg.DATASETS.CROP_SIZE
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        B, H, W, max_disp=cfg.SOLVER.MAX_DISP, seed=0, disp_quantum=8).items()}
    step(batch)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        step(batch)
    end.record()
    torch.cuda.synchronize()
    del model, optimizer, step
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / steps


def probe(cfg, steps):
    from ..data import synthetic_batch
    from ..models import build_criterion, build_model

    model = build_model(cfg)
    criterion = build_criterion(cfg)
    B = cfg.SOLVER.IMS_PER_BATCH
    H, W = cfg.DATASETS.CROP_SIZE
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        B, H, W, max_disp=cfg.SOLVER.MAX_DISP, seed=0, disp_quantum=8).items()}
    state = {k: v.clone() for k, v in model.state_dict().items()}
    a = _probe_pass(model, criterion, batch, state)
    b = _probe_pass(model, criterion, batch, state)
    report = {"total_equal": a[3] == b[3],
              "forward": _differ(a[0], b[0]),
              "output_gradients": _differ(a[1], b[1]),
              "parameter_gradients": _differ(a[2], b[2])}
    del model
    torch.cuda.empty_cache()
    report["step_ms"] = step_ms(cfg, steps)
    return report


def main(argv=None):
    import torch.utils.deterministic

    from ..config import get_cfg
    from ..utils.misc import deterministic
    from .convergence_gate import card

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config-file", default="")
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("determinism_probe: no CUDA device available", file=sys.stderr)
        return 1
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.freeze()
    report = {"config": args.config_file or "default", "card": card(),
              "without": probe(cfg, args.steps)}
    with deterministic():
        report["with"] = probe(cfg, args.steps)
    # the cost of each part of the settings
    parts = {}
    torch.backends.cudnn.deterministic = True
    parts["cudnn.deterministic alone"] = step_ms(cfg, args.steps)
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(True)
    parts["use_deterministic_algorithms alone"] = step_ms(cfg, args.steps)
    torch.utils.deterministic.fill_uninitialized_memory = False
    parts["use_deterministic_algorithms, no fill of new tensors"] = \
        step_ms(cfg, args.steps)
    torch.utils.deterministic.fill_uninitialized_memory = True
    torch.use_deterministic_algorithms(False)
    report["step_ms_by_setting"] = parts
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
