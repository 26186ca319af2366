"""Convergence gate of the port on the card (the counterpart of
``tools/train_convergence_gate.py``, same flags, recipe and output).

  1. trains the model on synthetic random-dot stereograms at the
     production recipe's shapes (crop 384x768, batch 8, bf16) for
     ``--steps`` steps, the OneCycle schedule spanning them;
  2. evaluates a fixed held-out synthetic set (``--holdout`` batches, the
     same scenes as the JAX gate's) at step 0, every ``--eval-period``
     steps and at the end, and passes only if the final held-out EPE is
     below ``--epe-thresh``;
  3. saves a checkpoint at ``--resume-at``, trains ``--resume-len`` more
     steps, restores the checkpoint into a second model and replays them:
     the losses, the weights and the AdamW state must equal the live run's
     bit for bit.

The whole run is deterministic (``utils.misc.deterministic``), which the
bitwise replay needs on the card.  ``TPU.REMAT`` stays off.  Writes a JSON
artifact (``--out``, default ``CONVERGENCE_H100.json`` at the repository
root) with the JAX gate's fields, the card's name and power limit, the
time per step, the peak memory and the determinism settings; exits 1 if
the gate did not pass.

    python -m nmrf_tpu_torch.tools.convergence_gate
    python -m nmrf_tpu_torch.tools.convergence_gate --config-file \\
        configs/sceneflow_swint.yaml --out CONVERGENCE_H100_SWIN.json

Smoke on the CPU (plain PyTorch versions of the kernels):

    python -m nmrf_tpu_torch.tools.convergence_gate --device cpu --steps 8 \\
        --eval-period 4 --holdout 1 --resume-at 2 --resume-len 2 \\
        --epe-thresh 1e9 --out /tmp/gate.json SOLVER.IMS_PER_BATCH 2 \\
        DATASETS.CROP_SIZE "(64, 128)" DPN.MAX_DISP 64 SOLVER.MAX_DISP 48
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_batch(cfg, step, synth_max_disp, rng_base=1234, align=8):
    """Per-step deterministic synthetic batch at the training crop (the JAX
    gate's draws: the same seeds give the same scenes)."""
    from ..data.synthetic import make_stereo_pair

    B = cfg.SOLVER.IMS_PER_BATCH
    H, W = cfg.DATASETS.CROP_SIZE
    items = [make_stereo_pair(H, W, max_disp=synth_max_disp,
                              rng=np.random.RandomState(rng_base + step * 1024 + b),
                              disp_quantum=align) for b in range(B)]
    img1, img2, disp, valid = (np.stack(x) for x in zip(*items))
    return {"img1": img1, "img2": img2, "disp": disp.astype(np.float32),
            "valid": valid}


def prefetched(cfg, first, last, synth_max_disp, align, depth=2):
    """``make_batch`` for steps ``first..last`` in order, made by two host
    threads up to ``depth`` steps ahead of the one yielded (numpy's draws
    release the interpreter lock), so the host makes the next batches while
    the card runs the step."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        pending = deque()
        for step in range(first, last + 1):
            pending.append(pool.submit(make_batch, cfg, step, synth_max_disp,
                                       align=align))
            if len(pending) > depth:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def card():
    """{"name", "power_limit"} as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--eval-period", type=int, default=200)
    p.add_argument("--holdout", type=int, default=8)
    p.add_argument("--epe-thresh", type=float, default=5.0)
    p.add_argument("--resume-at", type=int, default=60)
    p.add_argument("--resume-len", type=int, default=3)
    # the JAX gate's task: 48 px disparities on whole 1/8-resolution bins
    # (tools/train_convergence_gate.py says why); --synth-align 1 gives
    # the unaligned task
    p.add_argument("--synth-max-disp", type=int, default=48)
    p.add_argument("--synth-align", type=int, default=8)
    p.add_argument("--out", default=os.path.join(ROOT, "CONVERGENCE_H100.json"))
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--config-file", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def _clone_state(model, optimizer):
    def cpu(t):
        return t.detach().cpu().clone() if torch.is_tensor(t) else t

    return ({k: cpu(v) for k, v in model.state_dict().items()},
            {i: {k: cpu(v) for k, v in s.items()}
             for i, s in optimizer.state_dict()["state"].items()})


def _states_equal(a, b):
    (ma, oa), (mb, ob) = a, b
    if ma.keys() != mb.keys() or oa.keys() != ob.keys():
        return False
    return (all(torch.equal(ma[k], mb[k]) for k in ma)
            and all(torch.equal(oa[i][k], ob[i][k]) if torch.is_tensor(oa[i][k])
                    else oa[i][k] == ob[i][k] for i in oa for k in oa[i]))


def main(argv=None):
    from ..config import get_cfg
    from ..models import build_criterion, build_model, resolve_device
    from ..parallel import make_eval_step
    from ..solver import build_optimizer, build_scheduler, make_train_step
    from ..utils.checkpoint import (load_train_state, restore_checkpoint,
                                    save_checkpoint, train_state)
    from ..utils.misc import deterministic

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="convgate_")

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.DATASETS.CROP_SIZE = (384, 768)
    cfg.SOLVER.IMS_PER_BATCH = 8
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.REMAT = False  # the step fits the card without it
    cfg.SOLVER.MAX_ITER = args.steps  # OneCycle spans the gate's own length
    cfg.SOLVER.BASE_LR = 2e-4  # the JAX gate's peak lr for this horizon
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()

    def build():
        model = build_model(cfg, device=device)
        optimizer, scheduler = build_optimizer(model, cfg)
        return model, optimizer, scheduler

    def steps_of(model, optimizer, scheduler):
        return make_train_step(model, build_criterion(cfg), optimizer,
                               scheduler, cfg.SOLVER.ACCUM_STEPS,
                               grad_clip=cfg.SOLVER.GRAD_CLIP)

    def on_device(batch):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    H, W = cfg.DATASETS.CROP_SIZE
    hold = [make_batch(cfg, 10 ** 6 + i, args.synth_max_disp, rng_base=777,
                       align=args.synth_align) for i in range(args.holdout)]
    # unaligned variant of the same scenes: non-gating diagnostic
    hold_unaligned = [make_batch(cfg, 10 ** 6 + i, args.synth_max_disp,
                                 rng_base=777, align=1)
                      for i in range(args.holdout)]

    def holdout_epe(model, hold=hold):
        eval_fn = make_eval_step(model)
        tot, cnt = 0.0, 0
        for hb in hold:
            b = on_device(hb)
            disp = eval_fn(b["img1"], b["img2"])["disp"].float().cpu().numpy()
            err = np.abs(disp - hb["disp"])[hb["valid"]]
            tot += float(err.sum())
            cnt += int(err.size)
        return tot / max(cnt, 1)

    settings = {"torch.use_deterministic_algorithms": True,
                "torch.backends.cudnn.deterministic": True,
                "torch.backends.cudnn.benchmark": False,
                "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    log = {"recipe": {"crop": [H, W], "batch": cfg.SOLVER.IMS_PER_BATCH,
                      "dtype": cfg.TPU.COMPUTE_DTYPE, "steps": args.steps,
                      "epe_thresh": args.epe_thresh,
                      "base_lr": cfg.SOLVER.BASE_LR,
                      "schedule_max_iter": cfg.SOLVER.MAX_ITER,
                      "synth_max_disp": args.synth_max_disp,
                      "synth_align": args.synth_align,
                      "config_file": args.config_file or None,
                      "model": cfg.BACKBONE.MODEL_TYPE,
                      "remat": bool(cfg.TPU.REMAT)},
           "platform": "gpu" if device.type == "cuda" else device.type,
           "device": card() if device.type == "cuda" else {"name": "cpu"},
           "determinism": settings,
           "eval": [], "resume_equivalence": None}

    with deterministic():
        model, optimizer, scheduler = build()
        step_fn = steps_of(model, optimizer, scheduler)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        epe0 = holdout_epe(model)
        log["eval"].append({"step": 0, "holdout_epe": round(epe0, 4)})
        print(f"step 0: holdout EPE {epe0:.3f}", flush=True)

        train_s, traj_live, saved, live_after = 0.0, [], None, None
        sync()
        t0 = time.perf_counter()
        batches = prefetched(cfg, 1, args.steps, args.synth_max_disp,
                             args.synth_align)
        for s, batch in enumerate(batches, 1):
            losses = step_fn(on_device(batch))
            if s == args.resume_at:
                sync()
                train_s += time.perf_counter() - t0
                save_checkpoint(ckpt_dir, s, train_state(model, optimizer, s,
                                                         step_fn))
                saved = s
                t0 = time.perf_counter()
            if saved is not None and args.resume_at < s <= args.resume_at + args.resume_len:
                traj_live.append(float(losses["total"]))
                if s == args.resume_at + args.resume_len:
                    live_after = _clone_state(model, optimizer)
            if s % 20 == 0 or s == args.steps:
                tot = float(losses["total"])
                if not np.isfinite(tot):
                    raise SystemExit(f"step {s}: non-finite loss {losses}")
                if s % 100 == 0 or s == args.steps:
                    sync()
                    ms = (train_s + time.perf_counter() - t0) / s * 1e3
                    print(f"step {s}: loss {tot:.3f} ({ms:.2f} ms/step avg, "
                          "host batches included, evals and saves "
                          "excluded)", flush=True)
            if s % args.eval_period == 0 and s != args.steps:
                sync()
                train_s += time.perf_counter() - t0
                epe = holdout_epe(model)
                log["eval"].append({"step": s, "holdout_epe": round(epe, 4)})
                print(f"step {s}: holdout EPE {epe:.3f}", flush=True)
                with open(args.out, "w") as f:
                    json.dump({**log, "passed": None,
                               "note": "partial (in progress)"}, f, indent=2)
                t0 = time.perf_counter()
        sync()
        train_s += time.perf_counter() - t0
        log["ms_per_step"] = train_s / args.steps * 1e3
        if device.type == "cuda":
            log["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9

        # ---- resume equivalence: restore the checkpoint into a second
        # model and optimizer, rebuild the schedule and replay ----
        model2, optimizer2, _ = build()
        if saved is not None and args.resume_len > 0:
            state, _ = restore_checkpoint(ckpt_dir)
            start = load_train_state(state, model2, optimizer2)
            scheduler2 = build_scheduler(optimizer2, cfg,
                                         start // cfg.SOLVER.ACCUM_STEPS)
            replay_fn = steps_of(model2, optimizer2, scheduler2)
            replay_fn.load_state_dict(state["train_step"])
            traj_replay = []
            for batch in prefetched(cfg, saved + 1, saved + args.resume_len,
                                    args.synth_max_disp, args.synth_align):
                traj_replay.append(float(replay_fn(on_device(batch))["total"]))
            same_losses = traj_live == traj_replay
            same_state = _states_equal(live_after,
                                       _clone_state(model2, optimizer2))
            exact = bool(same_losses and same_state)
            log["resume_equivalence"] = {
                "saved_at": saved, "replay_steps": args.resume_len,
                "live": traj_live, "replay": traj_replay,
                "losses_equal": same_losses,
                "weights_and_adamw_equal": same_state, "exact": exact}
            print(f"resume equivalence: live {traj_live} replay {traj_replay} "
                  f"weights and AdamW state equal: {same_state} "
                  f"exact={exact}", flush=True)
        else:
            exact = True

        epe_final = holdout_epe(model)
        log["eval"].append({"step": args.steps, "holdout_epe": round(epe_final, 4)})
        epe_unal = holdout_epe(model, hold=hold_unaligned)
        log["unaligned_holdout_epe"] = round(epe_unal, 4)

        # ---- delta-head ablation: zero the sub-bin decode heads
        # (infer_head 8x8 deltas, refine_head 4x4 residuals) and evaluate
        # again; the gap is what those heads learned ----
        weights = model.state_dict()
        heads = [k for k in weights if k.startswith(("infer_head.", "refine_head."))]
        if not heads:
            raise SystemExit("no delta-head parameters matched")
        model2.load_state_dict({k: torch.zeros_like(v) if k in heads else v
                                for k, v in weights.items()})
        abl_aligned = holdout_epe(model2)
        abl_unal = holdout_epe(model2, hold=hold_unaligned)
    head_norms = {k: float(weights[k].float().norm()) for k in heads
                  if k.endswith(".weight")}
    log["delta_head_probe"] = {
        "ablated_holdout_epe": round(abl_aligned, 4),
        "ablated_unaligned_epe": round(abl_unal, 4),
        "gap_aligned": round(abl_aligned - epe_final, 4),
        "gap_unaligned": round(abl_unal - epe_unal, 4),
        "head_kernel_norms": head_norms,
        "note": "gap = EPE(delta heads zeroed) - EPE(full): the sub-bin "
                "structure the 8x8/4x4 decode heads contribute"}
    print(f"delta-head ablation: aligned {epe_final:.3f} -> "
          f"{abl_aligned:.3f}, unaligned {epe_unal:.3f} -> {abl_unal:.3f}",
          flush=True)
    log["unaligned_note"] = (
        "the same holdout scenes with sub-bin (unquantized) disparities: "
        "a non-gating diagnostic")
    log["passed"] = bool(epe_final < args.epe_thresh) and exact
    print(f"final holdout EPE {epe_final:.3f} (thresh {args.epe_thresh}) "
          f"unaligned-diagnostic {epe_unal:.3f} passed={log['passed']}",
          flush=True)
    with open(args.out, "w") as f:
        json.dump(log, f, indent=2)
    return 0 if log["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
