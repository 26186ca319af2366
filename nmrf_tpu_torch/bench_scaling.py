"""Weak-scaling sweep of the port's training step, with its communication
contract (root ``bench_scaling.py``; ``BASELINE.md``: >=80% scaling
efficiency at N >= 2).

    python -m nmrf_tpu_torch.bench_scaling [--device cuda|cpu] [--ranks N]
        [--iters 8] [--out PATH] [KEY VALUE ...]

The JAX script's config: ``DPN.MAX_DISP 64``, ``SOLVER.MAX_DISP 48``, crop
96x192, one image pair per data shard (``SOLVER.IMS_PER_BATCH 1``), then
the KEY VALUE overrides; the batch from numpy ``RandomState(0)`` as that
script draws it, the weights random from ``cfg.SEED``.  Weak scaling: the
data axis is swept over 1, 2, 4, 8 up to ``--ranks`` (default: the cards,
at least 2; 2 on the CPU), the global batch growing with it, and
efficiency(N) = t(1) / t(N).  Beside them the 1 x 2 (data, spatial) point
of the H-sharded path; with 8 ranks also the JAX script's (4, 2) hybrid and
its swin (2, 2) point (``configs/sceneflow_swint.yaml``,
``TPU.MSDA_TAP_RADIUS 2``).

Each point spawns its ranks (``parallel.spawn``): NCCL when every rank has
a card of its own, gloo when ranks share a card or run on the CPU.  A rank
takes one warm-up step, one step whose collectives it counts, then
``--iters`` steps timed on the host's clock and closed by a loss readback.
Where ranks share a card or run on the CPU the wall-time ratio measures
the sharing, not scaling: ``weak_scaling_efficiency`` is then null and the
raw ratio goes under ``wallclock_ratio_cpu_debug``, as the JAX script does
on virtual devices.

``collectives_per_step`` is the port's own count (``parallel.spatial.
CollectiveCounts``: every collective of the port goes through
``parallel.spatial.Group``), not HLO: per kind (``all_gather``,
``all_reduce``) the count and bytes of one step on rank 0, and per site.
The halo exchanges and the shifted-window rolls are all-gathers of edge
rows (the port has no permute).  :func:`check_comm_contract` holds each
point to the port's contract.

Prints one JSON line per point with the JAX script's row keys; writes the
record (``platform``, ``card``, ``crop``, ``per_device_batch``, ``note``,
``sweep``) to ``--out``, by default ``SCALING_H100.json`` at the repository
root on a card (nothing on the CPU), never to ``SCALING.json``.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWIN_CONFIG = os.path.join(ROOT, "configs", "sceneflow_swint.yaml")
ITERS = 8
# what a step may all-reduce besides the gradients: the tap metric's shares
# of the swin neck (a few floats); 1 KiB is far below one parameter tensor
SCALAR_BYTES = 1024
# the swin backbone's collectives on its H tiles (models/swin.py,
# models/adaptor.py): window halos, the gather of a stage run whole, the
# stem's and the ConvFFN's convolution halos, the neck's value halos and
# value gathers
SWIN_SITES = {"swin_halo", "swin_stage", "stem_halo", "ffn_halo", "msda_halo",
              "msda_value"}


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks of the largest data-parallel point (default: "
                        "the cards, at least 2; 2 on the CPU)")
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--out", default=None,
                   help="the record's path (default on a card: "
                        "SCALING_H100.json at the repository root)")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def sweep_cfg(opts=(), swin=False):
    """The sweep's config (module docstring), frozen."""
    from .config import get_cfg

    cfg = get_cfg()
    if swin:
        cfg.merge_from_file(SWIN_CONFIG)
        cfg.TPU.MSDA_TAP_RADIUS = 2
    cfg.DPN.MAX_DISP = 64
    cfg.SOLVER.MAX_DISP = 48
    cfg.DATASETS.CROP_SIZE = (96, 192)
    cfg.SOLVER.IMS_PER_BATCH = 1
    cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg


def mesh_points(ranks):
    """[(data, spatial, swin)] of the sweep for ``ranks`` ranks."""
    points = [(d, 1, False) for d in (1, 2, 4, 8) if d <= ranks]
    if ranks >= 2:
        points.append((1, 2, False))
    if ranks >= 8:
        points += [(4, 2, False), (2, 2, True)]
    return points


def sweep_batch(B, H, W, seed=0):
    """The JAX script's batch: images, disparities below 40, every pixel
    valid, from numpy ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    return {"img1": (rng.rand(B, H, W, 3) * 255).astype(np.float32),
            "img2": (rng.rand(B, H, W, 3) * 255).astype(np.float32),
            "disp": (rng.rand(B, H, W) * 40).astype(np.float32),
            "valid": np.ones((B, H, W), bool)}


def _mesh_worker(rank, cfg_dict, data, spatial, iters, device, threads,
                 out_dir):
    """One rank of a point (its own process): the step's ms, its
    collectives, the parameters' and the gathered outputs' bytes."""
    from .config.config import CfgNode
    from .models import build_criterion, build_model, resolve_device
    from .parallel import make_mesh, shard_batch, spatial_sharded_apply
    from .solver import build_optimizer, make_train_step

    torch.set_num_threads(threads)
    cfg = CfgNode(cfg_dict)
    cfg.freeze()
    world = data * spatial
    mesh = None
    if world > 1:
        mesh = make_mesh(data, spatial,
                         device=device if device == "cpu" else None)
        dev = mesh.device
    else:
        dev = resolve_device(device)
    model = build_model(cfg, device=dev, mesh=mesh)
    optimizer, scheduler = build_optimizer(model, cfg)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg.SOLVER.ACCUM_STEPS,
                           grad_clip=cfg.SOLVER.GRAD_CLIP, mesh=mesh)
    H, W = cfg.DATASETS.CROP_SIZE
    batch = sweep_batch(cfg.SOLVER.IMS_PER_BATCH * data, H, W)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    else:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    step(batch)  # warm-up: cuDNN's choices, the kernels' first launches
    sync()
    comm, output_bytes = {}, 0
    if mesh is not None:
        with torch.no_grad():  # the global outputs the step gathers
            model.train()
            out = spatial_sharded_apply(model, mesh, batch["img1"], batch["img2"])
            output_bytes = sum(v.numel() * v.element_size() for v in out.values())
            del out
        mesh.counts.reset()
        step(batch)
        sync()
        comm = mesh.counts.summary()
    t0 = time.perf_counter()
    for _ in range(iters):
        losses = step(batch)
    total = float(losses["total"])  # the readback closes the window
    dt = (time.perf_counter() - t0) / iters
    if not np.isfinite(total):
        raise RuntimeError(f"non-finite loss at mesh {data} x {spatial}: {total}")
    if rank == 0:
        with open(os.path.join(out_dir, "point.json"), "w") as f:
            json.dump({"seconds_per_step": dt, "comm": comm, "total": total,
                       "param_bytes": sum(p.numel() * 4
                                          for p in model.parameters()),
                       "output_bytes": output_bytes}, f)


def bench_mesh(cfg, data, spatial, iters=ITERS, device="cuda"):
    """Run one point in data x spatial new processes; returns (seconds a
    step, collectives of a step, the parameters' f32 bytes, the gathered
    outputs' bytes, backend)."""
    from .parallel import spawn

    world = data * spatial
    cards = torch.cuda.device_count() if device != "cpu" else 0
    backend = "nccl" if device != "cpu" and world <= cards else "gloo"
    threads = max(1, torch.get_num_threads() // world) if device == "cpu" \
        else torch.get_num_threads()
    with tempfile.TemporaryDirectory(prefix="bench_scaling_") as out:
        spawn(_mesh_worker, world, backend,
              args=(cfg.to_dict(), data, spatial, iters, device, threads, out),
              timeout_s=600)
        with open(os.path.join(out, "point.json")) as f:
            point = json.load(f)
    return (point["seconds_per_step"], point["comm"], point["param_bytes"],
            point["output_bytes"], backend)


def check_comm_contract(comm, param_bytes, data, spatial, output_bytes=0):
    """Hold one step's collectives (``collectives_per_step``) to the port's
    contract; raises AssertionError on a breach, else returns findings.

    * 1 x 1: no collective at all.
    * Every grid: the gradients go in one all-reduce of exactly the
      parameters' float32 bytes (``sum_gradients`` flattens ``.float()``
      gradients); besides it a step may all-reduce scalars only (the swin
      tap metric), at most ``SCALAR_BYTES``, and on a spatial axis the
      instance norms' moments and the backwards of the all-gathers (the
      stripe's; the swin backbone's stage and value gathers).
    * Data-parallel (spatial 1): the only all-gather is that of the
      outputs, exactly their global bytes ``output_bytes``: every rank
      computes the one global loss from them (``parallel/mesh.py``); no
      halo, roll or stripe gather and no moments.
    * Spatial: halo and roll or stripe gathers are present, and the
      outputs' gather is their global bytes; the swin backbone on its
      tiles adds its own sites (``SWIN_SITES``).

    The JAX contract's 1.75x and 512 B/px allowances describe XLA's
    partitioner; the port's counts are exact, so its bounds are too."""
    comm = comm or {}

    def site(kind, name):
        return comm.get(kind, {}).get("sites", {}).get(
            name, {"count": 0, "bytes": 0})

    def sites(kind):
        return set(comm.get(kind, {}).get("sites", {}))

    res = {"param_bytes": param_bytes}
    if data * spatial == 1:
        assert not comm, f"collectives on a 1 x 1 mesh: {comm}"
        return res
    grads = site("all_reduce", "gradients")
    assert grads == {"count": 1, "bytes": param_bytes}, (
        f"gradient all-reduce {grads} is not one call of the parameters' "
        f"{param_bytes} f32 bytes")
    reduces = sites("all_reduce") - {"gradients"}
    # on a spatial axis: the instance norms' moments and the all-gathers'
    # backwards (the sum of the gathered gradients)
    allowed = {"tap_metric", "moments", "stripe", "stem_moments",
               "swin_stage", "msda_value"} if spatial > 1 else {"tap_metric"}
    assert reduces <= allowed, f"unexpected all-reduces {reduces - allowed}"
    scalars = site("all_reduce", "tap_metric")["bytes"]
    assert scalars <= SCALAR_BYTES, (
        f"metric all-reduces of {scalars} B exceed {SCALAR_BYTES} B of scalars")
    outputs = site("all_gather", "outputs")["bytes"]
    assert outputs == output_bytes, (
        f"output all-gather {outputs} B vs the global outputs' {output_bytes} B")
    gathers = sites("all_gather") - {"outputs"}
    if spatial == 1:
        assert not gathers, (
            f"data-parallel step gathers {gathers}: a spatial collective on a "
            "mesh without a spatial axis")
    else:
        assert "halo" in gathers and gathers & {"roll", "stripe"}, (
            f"spatial mesh without halo and roll or stripe exchanges: {gathers}")
        known = {"halo", "roll", "stripe"} | SWIN_SITES
        assert gathers <= known, f"unexpected all-gathers {gathers - known}"
        res["halo_roll_stripe_bytes"] = sum(site("all_gather", s)["bytes"]
                                            for s in gathers)
        res["moments_stripe_allreduce_bytes"] = sum(
            site("all_reduce", s)["bytes"] for s in reduces - {"tap_metric"})
    res.update(gradient_allreduce_bytes=grads["bytes"],
               output_allgather_bytes=outputs, scalar_allreduce_bytes=scalars)
    return res


NOTE_SHARED = (
    "ranks share a card or run on the CPU: the wall-clock ratio measures the "
    "sharing, not scaling, so weak_scaling_efficiency is null and the raw "
    "ratio is under wallclock_ratio_cpu_debug.  collectives_per_step is the "
    "port's own exact count on rank 0 (parallel.spatial.CollectiveCounts): "
    "an all-gather's bytes are its result's, an all-reduce's its buffer's; "
    "halos and window rolls are all-gathers of edge rows, not permutes.  The "
    ">=80% target is judged with a card per rank (NCCL)")
NOTE_CARDS = (
    "a card per rank, NCCL.  collectives_per_step is the port's own exact "
    "count on rank 0 (parallel.spatial.CollectiveCounts): an all-gather's "
    "bytes are its result's, an all-reduce's its buffer's; halos and window "
    "rolls are all-gathers of edge rows, not permutes")


def main(argv=None):
    """Run the sweep; prints a JSON line a point and returns the record."""
    from .models import resolve_device
    from .utils.benchmarks import device_identity

    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    ranks = args.ranks or max(cards, 2)
    cfg = sweep_cfg(args.opts)
    swin_cfg = sweep_cfg(args.opts, swin=True)
    card = device_identity(device)
    print(f"bench_scaling: {card}; {ranks} ranks, {cards} cards",
          file=sys.stderr, flush=True)

    # efficiency is a scaling number only where every rank of every point
    # has a card of its own
    shared = device.type != "cuda" or ranks > cards
    rows, t1 = [], None
    for data, spatial, swin in mesh_points(ranks):
        c = swin_cfg if swin else cfg
        dt, comm, param_bytes, output_bytes, backend = bench_mesh(
            c, data, spatial, args.iters, device.type)
        if t1 is None and data * spatial == 1:
            t1 = dt
        eff = t1 / dt if t1 else None
        H, W = c.DATASETS.CROP_SIZE
        contract = check_comm_contract(comm, param_bytes, data, spatial,
                                       output_bytes)
        row = {
            "mesh": f"data={data}x spatial={spatial}",
            "variant": c.BACKBONE.MODEL_TYPE,
            "devices": data * spatial,
            "ms_per_step": dt * 1000.0,
            "global_batch": c.SOLVER.IMS_PER_BATCH * data,
            "weak_scaling_efficiency": (eff if eff and not swin and not shared
                                        else None),
            "collectives_per_step": comm,
            "comm_contract": contract,
            "backend": backend,
        }
        if eff and not swin and shared:
            row["wallclock_ratio_cpu_debug"] = eff
        rows.append(row)
        print(json.dumps(row), flush=True)

    record = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "card": card,
        "crop": list(cfg.DATASETS.CROP_SIZE),
        "per_device_batch": cfg.SOLVER.IMS_PER_BATCH,
        "note": NOTE_SHARED if shared else NOTE_CARDS,
        "sweep": rows,
    }
    out = args.out or (os.path.join(ROOT, "SCALING_H100.json")
                       if device.type == "cuda" else None)
    if out:
        with open(out, "w") as f:
            json.dump(record, f, indent=2)
    return record


if __name__ == "__main__":
    main()
