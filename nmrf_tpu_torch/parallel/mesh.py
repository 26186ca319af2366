"""The (data, spatial) process grid and the H-sharded forward
(``nmrf_tpu/parallel/mesh.py``).

World = data x spatial ranks; rank r sits at data index r // spatial and
spatial index r % spatial (the order of ``make_mesh``'s
``devices.reshape(data, spatial)``), and each data index has its own
spatial group.  Under :func:`spatial_sharded_apply`:

* **the backbone** runs on the rank's H tile of its data shard's images
  and returns the tile of both feature levels: the function the JAX
  package's GSPMD-partitioned backbone computes.  The resnet backbone with
  halo rows from the neighbour tiles and global instance-norm moments
  (``models/backbone.py``); the swin backbone with Swin-T's windows
  completed from the neighbour tiles, stages too short for a tile run
  whole on every rank, and the deformable neck's value maps exchanged for
  the rows its taps reach (``models/swin.py``, ``models/adaptor.py``);
* **the decode region** (cost volume through disparity,
  ``NMRF.decode``) runs on the tile, with the collectives of
  ``parallel/spatial.py`` inside the modules;
* **the outputs** are gathered into the global layouts on every rank
  (``_unspatial``), so the criterion runs on the global outputs with its
  global counts, as the one jit of the JAX step does.  The gather's
  backward takes the rank's own block of the gradient.

The global H divides evenly across the spatial axis, as in the JAX package,
into tiles whose height is a multiple of 8.
"""

import os

import torch
import torch.distributed as dist

from .spatial import CollectiveCounts, Group

# outputs with a leading layer axis: [L, B, H, ...]; the others are [B, H, ...]
_LAYER_KEYS = ("coarse_disp_layers", "logits_layers", "disp_pred_layers")


class Mesh:
    """This rank's view of the (data, spatial) grid: its indices, its
    device, the spatial group of its data index and the world group, and
    ``counts``, the ``spatial.CollectiveCounts`` of every collective this
    rank issues through them."""

    def __init__(self, data, spatial, backend, device):
        self.data, self.spatial, self.device = data, spatial, device
        self.rank = dist.get_rank()
        self.data_index = self.rank // spatial
        self.counts = CollectiveCounts()
        # every rank builds every group, in one order (new_group is collective)
        groups = [Group(range(d * spatial, (d + 1) * spatial), backend,
                        self.counts) for d in range(data)]
        self.spatial_group = groups[self.data_index]
        self.world = Group(range(data * spatial), backend, self.counts)


def _rank_device(device):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "nmrf_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def make_mesh(data=-1, spatial=1, backend=None, device=None):
    """The (data, spatial) grid over the initialised default process group
    (``parallel.spawn`` initialises one; on a cluster, the caller).
    data = -1 takes world / spatial.  backend: of the subgroups (default:
    the default group's): NCCL when every rank has its own card, gloo when
    ranks share a card or run on the CPU.  device: the rank's device,
    ``cuda:{LOCAL_RANK % device_count}`` unless given ("cpu" for the CPU
    tests); raises without CUDA."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(init_process_group with address, world size "
                           "and rank)")
    world = dist.get_world_size()
    if data == -1:
        if world % spatial:
            raise ValueError(f"world {world} not divisible by spatial {spatial}")
        data = world // spatial
    if data * spatial != world:
        raise ValueError(f"mesh {data} x {spatial} != world {world}")
    return Mesh(data, spatial, backend or dist.get_backend(),
                _rank_device(device))


def _to_device(value, device, non_blocking):
    value = torch.as_tensor(value)
    if non_blocking and device.type == "cuda":
        value = value.pin_memory()
    return value.to(device, non_blocking=non_blocking)


def shard_batch(batch, mesh):
    """This rank's part of a global training batch, on its device: the
    img1/img2 rows of its data index (whole images:
    ``spatial_sharded_apply`` cuts the H tile), and ``disp``/``valid``
    whole (the criterion runs on the global outputs).  The batch must
    divide over the data axis."""
    out = {}
    for key, value in batch.items():
        value = torch.as_tensor(value)
        if key in ("img1", "img2"):
            if value.shape[0] % mesh.data:
                raise ValueError(f"batch {value.shape[0]} does not divide over "
                                 f"{mesh.data} data ranks")
            n = value.shape[0] // mesh.data
            value = value[mesh.data_index * n:(mesh.data_index + 1) * n]
        out[key] = value.to(mesh.device)
    return out


def _step_batch(batch, mesh):
    """A data index's host batch (its rows of the global batch, as the
    sampler with ``rank=mesh.data_index, world_size=mesh.data`` gives it)
    -> the batch ``make_train_step(mesh=)`` takes, ``shard_batch``'s
    layout: these images on the rank's device, the targets of the whole
    global batch (one all-gather over the world, a copy per data index)."""
    out = {}
    for key, value in batch.items():
        value = _to_device(value, mesh.device, True)
        if key in ("disp", "valid") and mesh.data > 1:
            flag = value.dtype == torch.bool
            parts = mesh.world.all_gather(
                value.to(torch.uint8) if flag else value, "targets")
            value = torch.cat(parts[::mesh.spatial])
            value = value.bool() if flag else value
        out[key] = value
    return out


def device_prefetch(iterable, mesh=None, size=2, device=None):
    """Host batches (dicts of numpy arrays) -> batches on the device, with
    ``size`` batches' host-to-device copies started ahead of the one yielded:
    each is copied from pinned host memory without the host waiting for it,
    so the next batch's copy is queued before the step that comes first
    (``nmrf_tpu/parallel/mesh.py:device_prefetch``).  Without a mesh the
    whole batch goes to ``device``.  With a mesh each host batch is this
    data index's rows, and the result is the layout of ``shard_batch``
    (the targets gathered over the data axis): what the JAX package's
    ``shard_batch`` makes of a process-local batch."""
    from collections import deque

    def move(batch):
        if mesh is not None:
            return _step_batch(batch, mesh)
        return {k: _to_device(v, torch.device(device), True)
                for k, v in batch.items()}

    buf = deque()
    for batch in iterable:
        buf.append(move(batch))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def make_eval_step(model):
    """``eval_step(img1, img2) -> outputs``: the model's forward in eval
    mode under ``torch.inference_mode`` (``nmrf_tpu/parallel/mesh.py:
    make_eval_step``)."""

    def step(img1, img2):
        model.eval()
        with torch.inference_mode():
            return model(img1, img2)

    return step


class _GatherGlobal(torch.autograd.Function):
    """Blocks of a group laid out as rows x cols (batch x H) -> the global
    tensor.  Backward: the rank's own block of the gradient, no sum: every
    rank computes the one global loss from identical global outputs, and
    summing the group's identical gradients would count it group-size
    times."""

    @staticmethod
    def forward(ctx, x, group, rows, cols, b_ax):
        parts = group.all_gather(x, "outputs")
        ctx.args = (group.index, cols, b_ax, x.shape[b_ax], x.shape[b_ax + 1])
        return torch.cat([torch.cat(parts[r * cols:(r + 1) * cols], dim=b_ax + 1)
                          for r in range(rows)], dim=b_ax)

    @staticmethod
    def backward(ctx, g):
        index, cols, b_ax, B, H = ctx.args
        r, c = divmod(index, cols)
        return (g.narrow(b_ax, r * B, B).narrow(b_ax + 1, c * H, H),
                None, None, None, None)


def _unspatial(out):
    """Global spatially shaped outputs -> the reference flat layouts."""
    out = dict(out)
    B, h8, w8, D = out["prob"].shape
    out["prob"] = out["prob"].reshape(B * h8 * w8, D)
    out["proposal"] = out["proposal"].reshape(B, h8 * w8, -1)
    out["initial_proposal"] = out["initial_proposal"].reshape(B, h8 * w8, -1)
    return out


def _tile_height(H, mesh):
    h = H // mesh.spatial
    if h * mesh.spatial != H or h % 8:
        raise ValueError(f"image height {H} does not divide over {mesh.spatial} "
                         "spatial ranks into tiles whose height is a multiple "
                         "of 8")
    return h


def sharded_features(model, mesh, img1, img2):
    """The rank's H tile of both feature levels of each image (lists [1/8,
    1/4], as ``model.extract_feature`` gives them for the whole images):
    the backbone (resnet or swin, built with the mesh) on the rank's tile
    of the images."""
    sp = mesh.spatial_group
    h = _tile_height(img1.shape[1], mesh)
    return model.extract_feature(img1.narrow(1, sp.index * h, h),
                                 img2.narrow(1, sp.index * h, h))


def spatial_sharded_apply(model, mesh, img1, img2, replicated=False):
    """The NMRF forward (in the model's mode) with the image H axis over the
    mesh's spatial axis; the model is built with the mesh
    (``build_model(cfg, mesh=mesh)``).

    img1/img2: this rank's images: the rows of its data index, or with
    ``replicated`` the whole batch on every data index (an eval batch
    smaller than the data axis, ``mesh.py:141-149``: the data axis then
    repeats the work and the spatial axis shares it); their height divides
    over the spatial axis into tiles whose height is a multiple of 8
    (``ValueError`` otherwise).  Returns the global outputs in the layouts
    of ``model(img1, img2)`` on the whole batch, on every rank."""
    f1, f2 = sharded_features(model, mesh, img1, img2)
    out = model.decode(f1, f2, spatial_out=True)
    if replicated or mesh.data == 1:
        group, rows = mesh.spatial_group, 1
    else:
        group, rows = mesh.world, mesh.data
    out = {k: _GatherGlobal.apply(v, group, rows, mesh.spatial,
                                  1 if k in _LAYER_KEYS else 0)
           for k, v in out.items()}
    return _unspatial(out)


def make_sharded_forward(model, mesh):
    """Evaluation forward with H over the mesh's spatial axis:
    ``fwd(img1, img2)`` takes a global batch (the same on every rank) and
    returns the global outputs on every rank.  A batch that does not divide
    over the data axis (batch 1) is replicated over it."""

    def fwd(img1, img2):
        B = img1.shape[0]
        replicated = B % mesh.data != 0
        if not replicated:
            n = B // mesh.data
            img1 = img1[mesh.data_index * n:(mesh.data_index + 1) * n]
            img2 = img2[mesh.data_index * n:(mesh.data_index + 1) * n]
        model.eval()
        with torch.inference_mode():
            return spatial_sharded_apply(model, mesh, img1, img2, replicated)

    return fwd


def sum_gradients(params, mesh):
    """Replace every parameter's gradient by its sum over the world (one
    all-reduce of the flattened gradients, in float32).

    A sum and not DDP's mean: each rank's backward reaches the parameters
    only through its own block of the global outputs (the output gather's
    backward takes that block), and through the backbone's work on its
    tile plus the halo rows it read from its neighbours, whose gradients
    the halo exchange's backward sends back to the tiles they came from.
    The swin backbone's parameters too: a window cut by a tile edge is
    computed by both ranks, each keeping (and so differentiating) its own
    rows, and a Swin stage run whole on every rank is differentiated by
    each through its own rows' outputs only (the all-gather's backward
    sums the group's parts of its input gradient).  So the per-rank
    gradients are disjoint parts of the gradient of the one global loss
    and their sum is that gradient.  A mean would scale it by 1 / world
    size."""
    live = [p for p in params if p.grad is not None]
    if not live:
        return
    total = mesh.world.all_reduce(
        torch.cat([p.grad.reshape(-1).float() for p in live]), "gradients")
    offset = 0
    for p in live:
        n = p.numel()
        p.grad = total[offset:offset + n].view_as(p).to(p.grad.dtype)
        offset += n
