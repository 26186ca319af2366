"""The (data, spatial) process grid and the H-sharded forward
(``nmrf_tpu/parallel/mesh.py``).

World = data x spatial ranks; rank r sits at data index r // spatial and
spatial index r % spatial (the order of ``make_mesh``'s
``devices.reshape(data, spatial)``), and each data index has its own
spatial group.  Under :func:`spatial_sharded_apply`:

* **the backbone**: each rank runs it on its data shard's whole images and
  keeps its H tile of both feature levels.  That is the function the JAX
  package's GSPMD-partitioned convolutions compute; the backbone work is
  repeated on every rank of a spatial group (a halo-exchanged backbone is
  later work, ``ROADMAP.md``);
* **the decode region** (cost volume through disparity,
  ``NMRF.decode``) runs on the tile, with the collectives of
  ``parallel/spatial.py`` inside the modules;
* **the outputs** are gathered into the global layouts on every rank
  (``_unspatial``), so the criterion runs on the global outputs with its
  global counts, as the one jit of the JAX step does.  The gather's
  backward takes the rank's own block of the gradient.

The global H divides evenly across the spatial axis, as in the JAX package.
"""

import os

import torch
import torch.distributed as dist

from .spatial import Group

# outputs with a leading layer axis: [L, B, H, ...]; the others are [B, H, ...]
_LAYER_KEYS = ("coarse_disp_layers", "logits_layers", "disp_pred_layers")


class Mesh:
    """This rank's view of the (data, spatial) grid: its indices, its
    device, the spatial group of its data index and the world group."""

    def __init__(self, data, spatial, backend, device):
        self.data, self.spatial, self.device = data, spatial, device
        self.rank = dist.get_rank()
        self.data_index = self.rank // spatial
        # every rank builds every group, in one order (new_group is collective)
        groups = [Group(range(d * spatial, (d + 1) * spatial), backend)
                  for d in range(data)]
        self.spatial_group = groups[self.data_index]
        self.world = Group(range(data * spatial), backend)


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


def shard_batch(batch, mesh):
    """This rank's part of a global training batch, on its device: the
    img1/img2 rows of its data index (whole images: the backbone runs on
    them and the decode cuts the H tile), and ``disp``/``valid`` whole (the
    criterion runs on the global outputs).  The batch must divide over the
    data axis."""
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


class _GatherGlobal(torch.autograd.Function):
    """Blocks of a group laid out as rows x cols (batch x H) -> the global
    tensor.  Backward: the rank's own block of the gradient, no sum: every
    rank computes the one global loss from identical global outputs, and
    summing the group's identical gradients would count it group-size
    times."""

    @staticmethod
    def forward(ctx, x, group, rows, cols, b_ax):
        parts = group.all_gather(x)
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


def spatial_sharded_apply(model, mesh, img1, img2, replicated=False):
    """The NMRF forward (in the model's mode) with the image H axis over the
    mesh's spatial axis; the model is built with the mesh
    (``build_model(cfg, mesh=mesh)``).

    img1/img2: this rank's images: the rows of its data index, or with
    ``replicated`` the whole batch on every data index (an eval batch
    smaller than the data axis, ``mesh.py:141-149``: the data axis then
    repeats the work and the spatial axis shares it).  Returns the global
    outputs in the layouts of ``model(img1, img2)`` on the whole batch, on
    every rank."""
    sp = mesh.spatial_group

    def tile(f):
        h = f.shape[1] // mesh.spatial
        assert h * mesh.spatial == f.shape[1], (f.shape, mesh.spatial)
        return f.narrow(1, sp.index * h, h)

    f1, f2 = model.extract_feature(img1, img2)
    out = model.decode([tile(f) for f in f1], [tile(f) for f in f2],
                       spatial_out=True)
    if replicated or mesh.data == 1:
        group, rows = sp, 1
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
    all-reduce of the flattened gradients).

    A sum and not DDP's mean: each rank's backward reaches the parameters
    only through its own block of the global outputs (the output gather's
    backward takes that block; the backbone's work outside the rank's tile
    gets no gradient), so the per-rank gradients are disjoint parts of the
    gradient of the one global loss and their sum is that gradient.  A mean
    would scale it by 1 / world size."""
    live = [p for p in params if p.grad is not None]
    if not live:
        return
    total = mesh.world.all_reduce(
        torch.cat([p.grad.reshape(-1).float() for p in live]))
    offset = 0
    for p in live:
        n = p.numel()
        p.grad = total[offset:offset + n].view_as(p).to(p.grad.dtype)
        offset += n
