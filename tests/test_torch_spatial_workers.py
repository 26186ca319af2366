"""Process bodies of ``tests/test_torch_spatial.py``,
``tests/test_torch_spatial_fused.py``, ``tests/test_torch_swin_mesh.py``
and ``tests/test_torch_checkpoint.py``: each runs in a process of its own
(with torch.distributed initialised by ``nmrf_tpu_torch.parallel.spawn``,
gloo, on the CPU, where it needs one), imports PyTorch and the port only,
and saves what it computed to a directory the test reads.  This module
holds no tests."""

from pathlib import Path

import numpy as np
import torch

from nmrf_tpu_torch import build_criterion, build_model, get_cfg
from nmrf_tpu_torch.parallel import (make_mesh, make_sharded_forward,
                                     shard_batch, spatial_sharded_apply,
                                     sum_gradients)
from nmrf_tpu_torch.parallel import spatial as S

# the collectives' test tensors: [B, H_tile, W, C] tiles of a global image
TILE = (2, 4, 5, 3)


def collective_inputs(world):
    """Global input and the per-tile cotangents of every collective case."""
    rng = np.random.RandomState(0)
    B, H, W, C = TILE
    x = rng.randn(B, H * world, W, C).astype(np.float32)
    cot = {name: rng.randn(*shape).astype(np.float32)
           for name, shape in (("roll_up", (B, H * world, W, C)),
                               ("roll_down", (B, H * world, W, C)),
                               ("halo", (world, B, H + 2, W, C)),
                               ("halo_wrap", (world, B, H + 4, W, C)),
                               ("gather", (world, B, H * world, W, C)),
                               ("instance_norm", (B, H * world, W, C)))}
    return x, cot


def collective_cases(group):
    """name -> (sharded op of a tile, the tile's cotangent selector)."""
    H = TILE[1]
    tile = (lambda c: torch.from_numpy(c[:, group.index * H:(group.index + 1) * H]))
    own = (lambda c: torch.from_numpy(c[group.index]))
    return {
        "roll_up": (lambda x: S.global_roll_h(x, -3, group), tile),
        "roll_down": (lambda x: S.global_roll_h(x, 2, group), tile),
        "halo": (lambda x: S.halo_exchange_h(x, 1, group), own),
        "halo_wrap": (lambda x: S.halo_exchange_h(x, 2, group, wrap=True), own),
        "gather": (lambda x: S.all_gather_h(x, group), own),
        "instance_norm": (lambda x: S.instance_norm_2d_sharded(x, group), tile),
    }


def collectives_worker(rank, out_dir):
    """Every collective on this rank's tile: its output and the gradient of
    sum(output * cotangent) with respect to the tile."""
    torch.set_num_threads(1)
    world = torch.distributed.get_world_size()
    mesh = make_mesh(1, world, device="cpu")
    group = mesh.spatial_group
    x, cot = collective_inputs(world)
    H = TILE[1]
    result = {}
    for name, (op, select) in collective_cases(group).items():
        xt = torch.from_numpy(x[:, rank * H:(rank + 1) * H]).requires_grad_()
        out = op(xt)
        (out * select(cot[name])).sum().backward()
        result[name] = (out.detach(), xt.grad)
    torch.save(result, f"{out_dir}/collectives_{rank}.pt")


def small_cfg(data=1, spatial=1):
    """The test model: 2 layers per stage, DPN.MAX_DISP 64 (D 8 at 1/8)."""
    cfg = get_cfg()
    cfg.NMP.NUM_PROP_LAYERS = 2
    cfg.NMP.NUM_INFER_LAYERS = 2
    cfg.NMP.NUM_REFINE_LAYERS = 2
    cfg.SOLVER.LOSS_WEIGHTS = [1.0, 1.2, 1.4, 2.0]
    cfg.DPN.MAX_DISP = 64
    cfg.SOLVER.MAX_DISP = 48
    cfg.TPU.MESH_DATA = data
    cfg.TPU.MESH_SPATIAL = spatial
    return cfg


def model_worker(rank, data, spatial, in_dir, out_dir):
    """The sharded port on the weights and batch the test wrote: eval
    outputs of the batch (and, with a data axis, of its first pair alone,
    replicated over the data axis), the train losses, and the world-summed
    gradients of one backward."""
    torch.set_num_threads(1)
    cfg = small_cfg(data, spatial)
    mesh = make_mesh(cfg.TPU.MESH_DATA, cfg.TPU.MESH_SPATIAL, device="cpu")
    model = build_model(cfg, mesh=mesh)
    model.load_state_dict(torch.load(f"{in_dir}/weights.pt"), strict=True)
    batch = {k: v for k, v in np.load(f"{in_dir}/batch.npz").items()}
    img1, img2 = (torch.from_numpy(batch[k]) for k in ("img1", "img2"))

    fwd = make_sharded_forward(model, mesh)
    result = {"eval": {k: v.clone() for k, v in fwd(img1, img2).items()}}
    if data > 1:
        result["eval_b1"] = {k: v.clone() for k, v in fwd(img1[:1], img2[:1]).items()}

    model.train()
    local = shard_batch(batch, mesh)
    out = spatial_sharded_apply(model, mesh, local["img1"], local["img2"])
    losses = build_criterion(cfg)(out, local)
    losses["total"].backward()
    sum_gradients(list(model.parameters()), mesh)
    result["losses"] = {k: float(v.detach()) for k, v in losses.items()}
    result["grads"] = {k: p.grad for k, p in model.named_parameters()}
    result["logits"] = out["logits_layers"][-1].detach()
    torch.save(result, f"{out_dir}/model_{rank}.pt")


def fused_step_worker(rank, in_dir, out_dir):
    """One sharded training step on a 1 x spatial grid as ``model_worker``
    takes it, run with NMRF_FUSED_POS=1 in the environment: the losses, the
    world-summed gradients, and how often each window backward ran (on the
    CPU B7's plain version, and K1b's path is autograd of the plain
    forward)."""
    from nmrf_tpu_torch.ops import attention as A

    torch.set_num_threads(1)
    calls = {"window_attention_pos_bwd_plain": 0}
    plain = A.window_attention_pos_bwd_plain

    def counted(*args, **kw):
        calls["window_attention_pos_bwd_plain"] += 1
        return plain(*args, **kw)

    A.window_attention_pos_bwd_plain = counted
    cfg = small_cfg(1, torch.distributed.get_world_size())
    mesh = make_mesh(cfg.TPU.MESH_DATA, cfg.TPU.MESH_SPATIAL, device="cpu")
    model = build_model(cfg, mesh=mesh)
    model.load_state_dict(torch.load(f"{in_dir}/weights.pt"), strict=True)
    batch = {k: v for k, v in np.load(f"{in_dir}/batch.npz").items()}
    model.train()
    local = shard_batch(batch, mesh)
    out = spatial_sharded_apply(model, mesh, local["img1"], local["img2"])
    losses = build_criterion(cfg)(out, local)
    losses["total"].backward()
    sum_gradients(list(model.parameters()), mesh)
    torch.save({"losses": {k: float(v.detach()) for k, v in losses.items()},
                "grads": {k: p.grad for k, p in model.named_parameters()},
                "calls": calls}, f"{out_dir}/fused_{rank}.pt")


def swin_small_cfg(cfg):
    """The swin test config of ``tests/test_torch_swin_train.py:swin_cfg``
    on a config tree of either package (that function's module imports
    JAX): ``configs/sceneflow_swint.yaml``, 2 layers per NMP stage, the tap
    path with radius 5 through the kernels' functions."""
    root = Path(__file__).resolve().parent.parent
    cfg.merge_from_file(str(root / "configs" / "sceneflow_swint.yaml"))
    cfg.NMP.NUM_PROP_LAYERS = 2
    cfg.NMP.NUM_INFER_LAYERS = 2
    cfg.NMP.NUM_REFINE_LAYERS = 2
    cfg.SOLVER.LOSS_WEIGHTS = [1.0, 1.2, 1.4, 2.0]
    cfg.TPU.USE_PALLAS = True
    cfg.TPU.MSDA_TAP_RADIUS = 5
    return cfg


def swin_mesh_worker(rank, in_dir, out_dir):
    """The swin model on a data x 1 grid (the test's weights, its global
    batch and its global drop-path masks, replayed into each rank's
    ``DropPathMasks.draw_global``) through ``make_train_step(..., mesh=,
    monitor_oob=True)`` at lr 0 and no clip:

    * ``masks``: this rank's rows of 3 draws of the model's own seeded
      ``DropPathMasks`` (a backbone batch of 8: 4 pairs, keep 0.5), taken
      before any replay;
    * ``step``: the step's losses, the world-summed gradients it hands the
      optimizer, and this rank's final proposal logits;
    * ``pushed``: a second step in which this rank's samples (on rank 1
      only) are moved 8 level pixels right, beyond the tap radius: its
      ``msda_tap_oob``, each extractor's local shares of that step, and
      what ``read_oob`` with a fallback guard did (its value, whether the
      guard fired, the extractors' tap radii after)."""
    from nmrf_tpu_torch import build_optimizer, make_train_step
    from nmrf_tpu_torch.models.adaptor import MSDeformAttn
    from nmrf_tpu_torch.utils.guards import TapOOBGuard

    torch.set_num_threads(2)
    world = torch.distributed.get_world_size()
    cfg = swin_small_cfg(get_cfg())
    cfg.SOLVER.BASE_LR = 0.0
    mesh = make_mesh(world, 1, device="cpu")
    model = build_model(cfg, mesh=mesh)
    result = {"masks": [model.drop_path_masks.draw(8, 0.5) for _ in range(3)]}
    model.load_state_dict(torch.load(f"{in_dir}/weights.pt"), strict=True)
    batch = {k: torch.from_numpy(v) for k, v in np.load(f"{in_dir}/batch.npz").items()}
    replayed = torch.load(f"{in_dir}/masks.pt")
    calls = []

    def draw_global(n, keep):
        want_keep, mask = replayed[len(calls)]
        assert n == mask.numel() and abs(keep - want_keep) < 1e-9, (n, keep)
        calls.append(n)
        return mask

    model.drop_path_masks.draw_global = draw_global
    optimizer, scheduler = build_optimizer(model, cfg)
    grads = {}

    def update(*args, **kw):
        grads.update({k: p.grad.clone() for k, p in model.named_parameters()})

    optimizer.step = update
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           grad_clip=float("inf"), mesh=mesh, monitor_oob=True)
    logits = []
    hook = model.infer_score_head.register_forward_hook(
        lambda _m, _i, out: logits.append(out[-1].detach()))
    losses = step(shard_batch(batch, mesh))
    hook.remove()
    result["draws"] = len(calls)
    result["step"] = {"losses": {k: float(v) for k, v in losses.items()},
                      "grads": dict(grads), "logits": logits[-1]}

    attns = [m for m in model.modules() if isinstance(m, MSDeformAttn)]
    if rank == 1:
        for m in attns:
            sampling = m.sampling

            def pushed(query, ref, shapes, sampling=sampling):
                loc, w = sampling(query, ref, shapes)
                width = torch.tensor([float(w_) for _, w_ in shapes])
                shift = torch.zeros_like(loc)
                shift[..., 0] = (8.0 / width)[:, None]
                return loc + shift, w

            m.sampling = pushed
    calls.clear()
    oob = float(step(shard_batch(batch, mesh))["msda_tap_oob"])
    guard = TapOOBGuard(thresh=1e-3, fallback=True)
    result["pushed"] = {"oob": oob, "local": [m.oob.clone() for m in attns],
                        "read": step.read_oob(guard), "fired": guard.fired,
                        "radii": [m.tap_radius for m in attns]}
    torch.save(result, f"{out_dir}/swin_mesh_{rank}.pt")


RESUME_MICRO_STEPS = 8  # 4 updates of ACCUM_STEPS 2


def resume_cfg(max_iter=RESUME_MICRO_STEPS):
    """The exact-resume test's config: the swin test config with drop-path
    0.4, 2 micro-steps an update, a 64-disparity cost volume."""
    cfg = swin_small_cfg(get_cfg())
    cfg.DPN.MAX_DISP = 64
    cfg.SOLVER.MAX_DISP = 48
    cfg.SOLVER.ACCUM_STEPS = 2
    cfg.SOLVER.MAX_ITER = max_iter
    cfg.freeze()
    return cfg


def resume_batch(step):
    """The batch of micro-step ``step`` (1-based): 2 pairs at 64x128."""
    from nmrf_tpu_torch.data import synthetic_batch

    return {k: torch.from_numpy(v) for k, v in synthetic_batch(
        2, 64, 128, max_disp=48, seed=step, disp_quantum=8).items()}


def resume_worker(ckpt_dir, starts, out):
    """In a fresh process: for each saved step in ``starts``, restore it
    into a new model, optimizer, schedule and train step, run the
    micro-steps after it up to ``RESUME_MICRO_STEPS`` and save their losses
    and the final model and AdamW state to ``out``.  Deterministic
    (``utils.misc.deterministic``), as the run it is held against: on the
    CPU, with more than one thread, the accumulating index of the window
    tables' gradient adds in another order from run to run otherwise."""
    from nmrf_tpu_torch.utils.misc import deterministic

    torch.set_num_threads(2)
    with deterministic():
        torch.save({start: _resumed_run(ckpt_dir, start) for start in starts},
                   out)


def _resumed_run(ckpt_dir, start):
    from nmrf_tpu_torch import build_optimizer, make_train_step
    from nmrf_tpu_torch.solver import build_scheduler
    from nmrf_tpu_torch.utils.checkpoint import (load_train_state,
                                                 restore_checkpoint)

    cfg = resume_cfg()
    model = build_model(cfg, device="cpu")
    optimizer, _ = build_optimizer(model, cfg)
    state, _ = restore_checkpoint(ckpt_dir, start)
    step_no = load_train_state(state, model, optimizer)
    scheduler = build_scheduler(optimizer, cfg, step_no // cfg.SOLVER.ACCUM_STEPS)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg.SOLVER.ACCUM_STEPS, grad_clip=cfg.SOLVER.GRAD_CLIP)
    step.load_state_dict(state["train_step"])
    losses = [float(step(resume_batch(s))["total"])
              for s in range(step_no + 1, RESUME_MICRO_STEPS + 1)]
    return {"losses": losses, "model": model.state_dict(),
            "optimizer": optimizer.state_dict()["state"]}


def gather_worker(rank, out_dir):
    """``utils.dist``: rank r gathers r + 2 float64 values that a float32
    round trip would change, and the evaluator's metrics of its
    ``InferenceSampler`` shard of 5 frames (``eval_frames``) through
    ``metrics_gather_fn``."""
    from nmrf_tpu_torch.data import InferenceSampler
    from nmrf_tpu_torch.evalx import DispEvaluator
    from nmrf_tpu_torch.utils.dist import all_gather_float_lists, metrics_gather_fn

    world = torch.distributed.get_world_size()
    values = [1.0 + (rank + 1) * 1e-12 * (i + 1) for i in range(rank + 2)]
    evaluator = DispEvaluator(thres=["1.0", "3.0"], only_valid=True, max_disp=64,
                              eval_prop=True)
    inputs, outputs = eval_frames()
    for i in InferenceSampler(len(inputs), rank, world):
        evaluator.process(inputs[i], outputs[i])
    torch.save({"gathered": all_gather_float_lists(values),
                "empty": all_gather_float_lists([]),
                "metrics": evaluator.evaluate(gather_fn=metrics_gather_fn)},
               f"{out_dir}/gather_{rank}.pt")


def eval_frames(n=5, H=32, W=48):
    """n (inputs, outputs) pairs of the evaluator, [1, ...] numpy arrays."""
    rng = np.random.RandomState(4)
    frames = []
    for _ in range(n):
        disp = (rng.rand(1, H, W) * 50).astype(np.float32)
        inputs = {"disp": disp, "valid": rng.rand(1, H, W) > 0.2,
                  "img1": (rng.rand(1, H, W, 3) * 255).astype(np.float32)}
        outputs = {"disp": disp + rng.randn(1, H, W).astype(np.float32) * 4,
                   "proposal": (rng.rand(1, (H // 8) * (W // 8), 4) * 8).astype(np.float32)}
        frames.append((inputs, outputs))
    return [f[0] for f in frames], [f[1] for f in frames]
