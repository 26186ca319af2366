"""Training and evaluation CLI of the port, the counterpart of root
``train.py`` (reference ``main.py``): ``--config-file``,
``--checkpoint-dir``, ``--eval-only`` and trailing ``KEY VALUE`` config
overrides, plus ``--device`` (CUDA unless given; ``cpu`` runs the plain
PyTorch versions of the kernels).

    python -m nmrf_tpu_torch.train --checkpoint-dir DIR [KEY VALUE ...]
    python -m nmrf_tpu_torch.train --eval-only SOLVER.RESUME DIR [...]
    torchrun --nproc-per-node N -m nmrf_tpu_torch.train ...

Under ``torchrun`` (world above 1) the processes form the
``TPU.MESH_DATA`` x ``TPU.MESH_SPATIAL`` grid of ``parallel.make_mesh``:
each data index loads its rows of every global batch, rank 0 alone saves
checkpoints, and evaluation shards the dataset over the data indices and
gathers the metrics.

A resumed run (``SOLVER.RESUME`` a checkpoint directory) continues the
saved one exactly: the model, AdamW, the drop-path generator and the
accumulation state come from the checkpoint (``utils/checkpoint.py``), the
schedule is rebuilt from the config at the saved number of updates, and
the loader starts at the saved step's epoch and batch.
"""

import argparse
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist


def get_args_parser():
    parser = argparse.ArgumentParser(
        "NMRF training (PyTorch)",
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--checkpoint-dir", default="checkpoints/sceneflow", type=str)
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="space-separated KEY VALUE config override pairs")
    return parser


def setup(args, rank=0, world=1):
    from .config import get_cfg
    from .utils import (check_path, collect_env_info, get_sha, seed_all_rng,
                        setup_logger)

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts or [])
    cfg.freeze()

    if rank == 0 and args.checkpoint_dir:
        check_path(args.checkpoint_dir)
    logger = setup_logger(args.checkpoint_dir, distributed_rank=rank)
    logger.info(f"Rank of current process: {rank}. World size: {world}")
    logger.info("Environment info:\n" + collect_env_info())
    logger.info(f"git:\n {get_sha()}\n")
    logger.info("Command line arguments: " + str(args))
    if rank == 0 and args.checkpoint_dir:
        with open(os.path.join(args.checkpoint_dir, "config.yaml"), "w") as f:
            f.write(cfg.dump())
    seed_all_rng(None if cfg.SEED < 0 else cfg.SEED + rank)
    return cfg


def evaluate(eval_step, cfg, logger, device, mesh=None, timing=None):
    """Per-dataset evaluation (reference main.py:302-324, root
    ``train.py:evaluate``).

    ``eval_step(img1, img2)`` takes [1, H, W, 3] tensors on ``device``.
    Each frame is padded by ``InputPadder`` to ``DATASETS.DIVIS_BY`` and
    then edge-padded to a multiple of ``TPU.EVAL_BUCKET``, as the JAX CLI
    pads it (the padding changes the windows the model sees, so the metrics
    are the JAX evaluator's).  With a mesh each data index evaluates its
    contiguous ``InferenceSampler`` shard and ``metrics_gather_fn``
    reassembles the per-sample metrics.  ``timing``: a dict that gets the
    seconds and frames evaluated added under ``eval_s`` and
    ``eval_frames``."""
    from .data import InferenceSampler, InputPadder, build_val_dataset
    from .evalx import DispEvaluator, inference_on_dataset, print_csv_format

    t0 = time.perf_counter()
    frames = 0
    results = {}
    for idx, name in enumerate(cfg.DATASETS.TEST):
        dataset = build_val_dataset(cfg, name)
        sampler = InferenceSampler(
            len(dataset), rank=mesh.data_index if mesh else 0,
            world_size=mesh.data if mesh else 1)
        evaluator = DispEvaluator(
            thres=cfg.TEST.EVAL_THRESH[idx],
            only_valid=cfg.TEST.EVAL_ONLY_VALID[idx],
            max_disp=cfg.TEST.EVAL_MAX_DISP[idx],
            eval_prop=cfg.TEST.EVAL_PROP[idx],
            divis_by=cfg.DATASETS.DIVIS_BY)

        def data_iter():
            for i in sampler:
                s = dataset[i]
                yield {k: (v[None] if isinstance(v, np.ndarray) else [v])
                       for k, v in s.items()}

        bucket = cfg.TPU.EVAL_BUCKET

        def run_model(sample):
            img1, img2 = sample["img1"][0], sample["img2"][0]
            padder = InputPadder(img1.shape, mode="proposal",
                                 divis_by=max(cfg.DATASETS.DIVIS_BY, 1))
            p1, p2 = padder.pad(img1, img2)
            H, W = p1.shape[:2]
            Hb = -(-H // bucket) * bucket
            Wb = -(-W // bucket) * bucket
            pb = [(0, Hb - H), (0, Wb - W), (0, 0)]
            p1b = np.pad(p1, pb, mode="edge")
            p2b = np.pad(p2, pb, mode="edge")
            out = eval_step(
                torch.from_numpy(np.ascontiguousarray(p1b[None], np.float32)).to(device),
                torch.from_numpy(np.ascontiguousarray(p2b[None], np.float32)).to(device))
            disp = out["disp"].float().cpu().numpy()[:, :H, :W]
            res = {"disp": padder.unpad(disp)}
            if "proposal" in out:
                # crop the 1/8-res proposal grid from the bucket-padded
                # extent back to the padder extent the evaluator expects
                prop = out["proposal"].float().cpu().numpy()
                hb, wb, hp, wp = Hb // 8, Wb // 8, H // 8, W // 8
                prop = prop.reshape(-1, hb, wb, prop.shape[-1])[:, :hp, :wp]
                res["proposal"] = prop.reshape(prop.shape[0], hp * wp, -1)
            return res

        gather_fn = None
        if mesh is not None:
            from .utils.dist import metrics_gather_fn as gather_fn
        results[name] = inference_on_dataset(run_model, data_iter(), evaluator,
                                             total=len(sampler),
                                             gather_fn=gather_fn)
        frames += len(sampler)
        logger.info(f"Evaluation results for {name} in csv format:")
        print_csv_format(results[name], logger)
    if timing is not None:
        timing["eval_s"] = timing.get("eval_s", 0.0) + time.perf_counter() - t0
        timing["eval_frames"] = timing.get("eval_frames", 0) + frames
    if len(results) == 1:
        results = list(results.values())[0]
    return results


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None).  Returns a
    summary: the step reached, the losses read at the log points, the last
    evaluation's results and the seconds spent restoring, training
    (``train_s`` over ``steps`` steps), saving and evaluating."""
    from .models import resolve_device

    args = get_args_parser().parse_args(argv)
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
    from .data import PrefetchLoader, ShardedBatchSampler, build_train_dataset
    from .models import build_criterion, build_model
    from .parallel import (device_prefetch, make_eval_step, make_mesh,
                           make_sharded_forward)
    from .solver import build_optimizer, build_scheduler, make_train_step
    from .utils import MetricLogger, SmoothedValue
    from .utils.checkpoint import (load_torch_checkpoint, load_train_state,
                                   prune_stale_latest, restore_checkpoint,
                                   save_checkpoint, train_state)
    from .utils.guards import TapOOBGuard

    rank = dist.get_rank() if world > 1 else 0
    cfg = setup(args, rank, world)
    logger = logging.getLogger("nmrf_tpu_torch")
    mesh = None
    if world > 1:
        mesh = make_mesh(cfg.TPU.MESH_DATA, cfg.TPU.MESH_SPATIAL,
                         device="cpu" if device.type == "cpu" else None)
        device = mesh.device

    model = build_model(cfg, device=device, mesh=mesh)
    logger.info("Number of params:" + str(sum(p.numel() for p in model.parameters())))
    if cfg.BACKBONE.MODEL_TYPE == "swin" and cfg.BACKBONE.WEIGHT_URL:
        from .utils.checkpoint import load_pretrained_swin

        load_pretrained_swin(model, cfg.BACKBONE.WEIGHT_URL)
        logger.info(f"Loaded pretrained backbone weights from {cfg.BACKBONE.WEIGHT_URL}")
    optimizer, scheduler = build_optimizer(model, cfg)

    timing = {"restore_s": 0.0, "train_s": 0.0, "steps": 0, "save_s": 0.0,
              "saves": 0}
    summary = {"step": 0, "losses": [], "results": None, "timing": timing}
    start_step, step_state = 0, None
    resume = cfg.SOLVER.RESUME
    if resume:
        logger.info("Load checkpoint: %s" % resume)
        t0 = time.perf_counter()
        if resume.endswith(".pth"):
            unmatched = load_torch_checkpoint(model, resume)
            if unmatched and cfg.SOLVER.STRICT_RESUME:
                raise ValueError(f"unmatched torch keys: {unmatched[:10]}...")
        else:
            state, _ = restore_checkpoint(resume)
            keep_opt = not cfg.SOLVER.NO_RESUME_OPTIMIZER
            start_step = load_train_state(state, model,
                                          optimizer if keep_opt else None)
            if keep_opt:
                # a fresh optimizer restarts the schedule and the
                # accumulation, as a fresh optax state does in the JAX CLI
                scheduler = build_scheduler(
                    optimizer, cfg, start_step // cfg.SOLVER.ACCUM_STEPS)
                step_state = state.get("train_step")
        _sync(device)
        timing["restore_s"] = time.perf_counter() - t0
    summary["step"] = start_step

    if mesh is not None and mesh.spatial > 1:
        eval_step = make_sharded_forward(model, mesh)
    else:
        eval_step = make_eval_step(model)

    if args.eval_only:
        summary["results"] = evaluate(eval_step, cfg, logger, device, mesh,
                                      timing)
        return summary

    # tap-MSDA exactness guard (root train.py:220-232): monitor the share of
    # samples beyond the tap radius in swin training; warn, and fall back to
    # the exact gather path in place when the config asks (read_oob)
    tap_guard = TapOOBGuard.from_cfg(cfg, logger)
    monitor_oob = (cfg.BACKBONE.MODEL_TYPE == "swin"
                   and cfg.TPU.MSDA_TAP_RADIUS > 0 and tap_guard.enabled)
    train_step = make_train_step(
        model, build_criterion(cfg), optimizer, scheduler,
        cfg.SOLVER.ACCUM_STEPS, grad_clip=cfg.SOLVER.GRAD_CLIP, mesh=mesh,
        monitor_oob=monitor_oob)
    if step_state is not None:
        train_step.load_state_dict(step_state)

    dataset = build_train_dataset(cfg)
    sampler = ShardedBatchSampler(
        len(dataset), cfg.SOLVER.IMS_PER_BATCH,
        rank=mesh.data_index if mesh else 0,
        world_size=mesh.data if mesh else 1, seed=max(cfg.SEED, 0))
    steps_per_epoch = sampler.epoch_indices(0).shape[0]
    if steps_per_epoch == 0:
        raise ValueError(f"{len(dataset)} training samples make no batch of "
                         f"{cfg.SOLVER.IMS_PER_BATCH}")
    epoch, skip = divmod(start_step, steps_per_epoch)
    loader = PrefetchLoader(dataset, sampler,
                            num_workers=cfg.DATALOADER.NUM_WORKERS,
                            use_processes=cfg.DATALOADER.USE_PROCESSES,
                            seed=max(cfg.SEED, 0), start_epoch=epoch,
                            start_step=skip)

    writer = None
    if rank == 0:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logger.info("tensorboard is not installed: no event files")
        else:
            writer = SummaryWriter(args.checkpoint_dir)

    total_steps = start_step
    metric_logger = MetricLogger(delimiter="  ")
    metric_logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.7f}"))
    logger.info("Start training")
    log_freq = 20  # reference logs every 20 iters (main.py:412)
    t_loop = time.perf_counter()
    try:
        while total_steps < cfg.SOLVER.MAX_ITER:
            header = f"Epoch: [{epoch}]"
            for i, batch in enumerate(metric_logger.log_every(
                    device_prefetch(loader, mesh, device=device), log_freq,
                    header, logger=logger, total=len(loader))):
                lr = optimizer.param_groups[0]["lr"]  # this micro-step's update
                losses = train_step(batch)
                total_steps += 1
                timing["steps"] += 1
                # the losses stay on the device between log points: a read
                # back every step would make the host wait for the device
                if i % log_freq == 0 or total_steps == cfg.SOLVER.MAX_ITER:
                    host_losses = {k: float(v) for k, v in losses.items()}
                    if monitor_oob:
                        train_step.read_oob(tap_guard)
                    summary["losses"].append({"step": total_steps, **host_losses})
                    metric_logger.update(lr=lr)
                    metric_logger.update(epoch=epoch)  # reference main.py:404
                    metric_logger.update(**host_losses)
                    if writer is not None:
                        for k, v in host_losses.items():
                            writer.add_scalar(f"train/{k}", v, total_steps - 1)
                if (total_steps % cfg.SOLVER.LATEST_CHECKPOINT_PERIOD == 0
                        or total_steps % cfg.SOLVER.CHECKPOINT_PERIOD == 0
                        or total_steps == cfg.SOLVER.MAX_ITER):
                    t0 = time.perf_counter()
                    state = train_state(model, optimizer, total_steps,
                                        train_step)
                    if rank == 0:
                        save_checkpoint(args.checkpoint_dir, total_steps, state)
                        # reference retention: one rolling latest and the
                        # periodic snapshots (main.py:449)
                        prune_stale_latest(args.checkpoint_dir, total_steps,
                                           cfg.SOLVER.CHECKPOINT_PERIOD)
                    timing["save_s"] += time.perf_counter() - t0
                    timing["saves"] += 1
                if cfg.TEST.EVAL_PERIOD > 0 and total_steps % cfg.TEST.EVAL_PERIOD == 0:
                    logger.info("Start validation")
                    summary["results"] = evaluate(eval_step, cfg, logger,
                                                  device, mesh, timing)
                if total_steps >= cfg.SOLVER.MAX_ITER:
                    logger.info("Training done")
                    break
            epoch += 1
    finally:
        loader.shutdown()
        if writer is not None:
            writer.close()
    _sync(device)
    timing["train_s"] = (time.perf_counter() - t_loop - timing["save_s"]
                         - timing.get("eval_s", 0.0))
    summary["step"] = total_steps
    return summary


if __name__ == "__main__":
    main()
