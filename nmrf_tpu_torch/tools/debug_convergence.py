"""Convergence-gate diagnosis: the single-batch overfit probe with
prediction stats (the counterpart of ``tools/debug_convergence.py``, same
flags, recipe and lines).

It answers two questions about the training recipe on the card:

  1. Can the model overfit one fixed production-shape batch?  If not, the
     fault is in the model or the optimizer, not in the task.
  2. What do the predictions look like: constant, clipped, and at which
     stage (the initial proposals, the refined proposals or the decoded
     disparity) does the signal die?

The recipe is the JAX tool's: crop 384x768, batch 8, bf16, ``TPU.REMAT
True``, ``SOLVER.MAX_ITER`` = ``--steps`` (the OneCycle schedule spans the
run), then the KEY VALUE overrides (``SOLVER.BASE_LR 1e-4``, or
``--config-file configs/sceneflow_swint.yaml`` for the swin variant).  The
batch is ``tools/convergence_gate.py:make_batch``'s synthetic random-dot
stereograms with disparities up to ``--synth-max-disp`` rounded to
multiples of ``--synth-align`` (0 or 1: unaligned); ``--overfit 1`` trains
on the first step's batch throughout, 0 on a fresh batch each step.

    python -m nmrf_tpu_torch.tools.debug_convergence [--steps 300]
        [--synth-max-disp 48] [--synth-align 8] [--overfit 1]
        [--config-file FILE] [--device cuda] [KEY VALUE ...]

Prints the ground truth's stats, ``step N: lr ... {losses}`` every 20
steps, the prediction stats of the fixed batch's first pair at init and
every 50 steps (``[tag N] disp: mean .. std .. min .. max .. EPE ..`` and
each proposal set's best-candidate EPE against GT/8 on the 1/8 centre
samples with its mean and max), and the average ms a step, timed on the
device clock (synchronised around the steps, the evaluations left out).
"""

import argparse
import time

import numpy as np
import torch

PROPOSAL_KEYS = ("initial_proposal", "proposal")


def prediction_stats(out, gt, valid):
    """The JAX tool's statistics of one eval forward's first pair: its
    disparity's mean and std over the valid pixels, min and max over all,
    EPE against ``gt`` [H, W] over ``valid``; and for each proposal set
    (1/8-resolution candidates in 1/8-pixel units, [B, h8 * w8, N]) the
    mean over the valid centre samples ``[3::8, 3::8]`` of its best
    candidate's distance to GT/8, with the candidates' mean and max.
    Values are numpy or torch; returns {name: float}."""
    d = np.asarray(torch.as_tensor(out["disp"]).float().cpu())[0]
    gt, valid = np.asarray(gt), np.asarray(valid, bool)
    stats = {"mean": float(d[valid].mean()), "std": float(d[valid].std()),
             "min": float(d.min()), "max": float(d.max()),
             "epe": float(np.abs(d - gt)[valid].mean())}
    g8 = gt[3::8, 3::8] / 8.0
    v8 = valid[3::8, 3::8]
    for key in PROPOSAL_KEYS:
        if key not in out:
            continue
        p = np.asarray(torch.as_tensor(out[key]).float().cpu())[0]
        p = p.reshape(*g8.shape, -1)
        best = np.min(np.abs(p - g8[..., None]), axis=-1)
        stats[f"{key}_bestEPE"] = float(best[v8].mean())
        stats[f"{key}_mean"] = float(p.mean())
        stats[f"{key}_max"] = float(p.max())
    return stats


def stats_line(tag, step, stats):
    """The JAX tool's line of ``prediction_stats``."""
    line = (f"[{tag} {step}] disp: mean {stats['mean']:.3f} "
            f"std {stats['std']:.3f} min {stats['min']:.2f} "
            f"max {stats['max']:.2f} EPE {stats['epe']:.3f}")
    for key in PROPOSAL_KEYS:
        if f"{key}_bestEPE" in stats:
            line += f"  {key}_bestEPE {stats[key + '_bestEPE']:.3f}"
            line += (f" {key}[mean {stats[key + '_mean']:.2f} "
                     f"max {stats[key + '_max']:.1f}]")
    return line


def overfit_probe(model, cfg, steps, synth_max_disp=48, synth_align=8,
                  overfit=True, log=print):
    """Train ``model`` (built from ``cfg``) for ``steps`` steps through the
    port's ``make_train_step`` on ``convergence_gate.make_batch``'s batches
    (the first step's throughout with ``overfit``), printing the JAX tool's lines
    through ``log``.  Returns {"gt": GT stats, "losses": [(step, lr,
    {name: value})] every 20 steps, "stats": [(tag, step, prediction
    stats)] at init and every 50 steps, "history": every step's losses
    (read back at the end), "ms_per_step"}."""
    from ..models import build_criterion
    from ..parallel import make_eval_step
    from ..solver import build_optimizer, make_train_step
    from .convergence_gate import make_batch

    device = next(model.parameters()).device
    optimizer, scheduler = build_optimizer(model, cfg)
    step_fn = make_train_step(model, build_criterion(cfg), optimizer,
                              scheduler, cfg.SOLVER.ACCUM_STEPS,
                              grad_clip=cfg.SOLVER.GRAD_CLIP)
    eval_fn = make_eval_step(model)

    def on_device(batch):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fixed = make_batch(cfg, 1, synth_max_disp, align=synth_align)
    fixed_dev = on_device(fixed)
    gt, vd = fixed["disp"][0], fixed["valid"][0]
    result = {"gt": {"mean": float(gt[vd].mean()), "std": float(gt[vd].std()),
                     "max": float(gt[vd].max())},
              "losses": [], "stats": []}
    history = []
    log(f"GT disp stats: mean {result['gt']['mean']:.2f} "
        f"std {result['gt']['std']:.2f} max {result['gt']['max']:.1f}")

    def eval_stats(tag, step):
        out = eval_fn(fixed_dev["img1"][:1], fixed_dev["img2"][:1])
        stats = prediction_stats(out, gt, vd)
        result["stats"].append((tag, step, stats))
        log(stats_line(tag, step, stats))

    eval_stats("init", 0)
    tag = "overfit" if overfit else "fresh"
    train_s = 0.0
    sync()
    t0 = time.perf_counter()
    for s in range(1, steps + 1):
        batch = fixed_dev if overfit else on_device(
            make_batch(cfg, s, synth_max_disp, align=synth_align))
        lr = optimizer.param_groups[0]["lr"]
        losses = step_fn(batch)
        history.append(losses)
        if s % 20 == 0 or s == steps:
            host = {k: round(float(v), 3) for k, v in losses.items()}
            result["losses"].append((s, lr, host))
            log(f"step {s}: lr {lr:.2e} " + str(host))
        if s % 50 == 0 or s == steps:
            sync()
            train_s += time.perf_counter() - t0
            eval_stats(tag, s)
            sync()
            t0 = time.perf_counter()
    sync()
    train_s += time.perf_counter() - t0
    result["ms_per_step"] = train_s / max(steps, 1) * 1e3
    result["history"] = [{k: float(v) for k, v in h.items()} for h in history]
    log(f"avg {result['ms_per_step']:.0f} ms/step")
    return result


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--synth-max-disp", type=int, default=48)
    p.add_argument("--synth-align", type=int, default=8)
    p.add_argument("--overfit", type=int, default=1,
                   help="1: one fixed batch; 0: a fresh batch each step")
    p.add_argument("--config-file", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def main(argv=None):
    """Run the probe; returns ``overfit_probe``'s result."""
    from ..config import get_cfg
    from ..models import build_model, resolve_device

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.DATASETS.CROP_SIZE = (384, 768)
    cfg.SOLVER.IMS_PER_BATCH = 8
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.REMAT = True
    cfg.SOLVER.MAX_ITER = args.steps
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()
    model = build_model(cfg, device=device)
    return overfit_probe(model, cfg, args.steps, args.synth_max_disp,
                         args.synth_align, bool(args.overfit),
                         log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
