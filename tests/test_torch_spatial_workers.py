"""Process bodies of ``tests/test_torch_spatial.py``: each runs in a process
of its own with torch.distributed initialised by
``nmrf_tpu_torch.parallel.spawn`` (gloo, on the CPU), imports PyTorch and
the port only, and saves what it computed to a directory the test reads.
This module holds no tests."""

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
