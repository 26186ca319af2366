"""Spatial (H-axis) sharding primitives over ``torch.distributed``
(``nmrf_tpu/parallel/spatial.py``).

The image plane is this model's sequence axis.  Split over H across the
ranks of a spatial group:

* plain windows need no communication (a tile holds whole windows);
* SHIFTED windows are a global cyclic roll along H: the ``shift`` boundary
  rows move to the ring neighbour (:func:`global_roll_h`);
* CSWin vertical stripes span the global H: queries stay local, keys and
  values are all-gathered (:func:`all_gather_h`);
* a 3x3 convolution needs a 1-row halo from each neighbour
  (:func:`halo_exchange_h`), an instance norm global moments
  (:func:`instance_norm_2d_sharded`).

Every collective is a ``torch.autograd.Function`` whose backward is the
adjoint collective: the roll's is the opposite roll, the halo exchange's
sends the halo gradients back and adds them to the edge rows, the
all-gather's sums the gathered gradient over the group and takes the local
slice, the mean's is the mean of the gradients.  They are built from
``all_gather`` and ``all_reduce`` only, which gloo and NCCL both have
(``torch.distributed.nn.functional``'s all-gather backward needs
``reduce_scatter``, which gloo lacks): the rolls and halo exchanges are
all-gathers of edge rows, not permutes.  Every collective of the port goes
through :class:`Group`, which counts each call by site
(:class:`CollectiveCounts`).  The global H divides evenly across the
group, as in the JAX package.

gloo runs all three of them on CUDA tensors itself (PyTorch 2.11 on the
H100 machine, ``tests/test_torch_gpu.py::test_gloo_collectives_on_cuda``),
so the layer hands every tensor to the backend as it is, with no copy to
host memory, for gloo and NCCL alike.
"""

import socket
import sys
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist


class CollectiveCounts:
    """The collectives issued through the groups that share this object (a
    mesh's groups share one): per kind (``all_gather``, ``all_reduce``) and
    per site (the caller's name for what it moves: ``halo``, ``roll``,
    ``stripe``, ``moments``, ``outputs``, ``gradients``, ...), the count of
    calls and their bytes.  An all-gather's bytes are those of its result
    (group size x the input's), an all-reduce's those of the reduced buffer,
    as the shapes of the HLO collectives that root ``bench_scaling.py``
    counts.
    Each rank counts the calls it makes."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls = {}

    def add(self, kind, site, nbytes):
        row = self.calls.setdefault((kind, site), [0, 0])
        row[0] += 1
        row[1] += nbytes

    def summary(self):
        """{kind: {"count", "bytes", "sites": {site: {"count", "bytes"}}}}."""
        out = {}
        for (kind, site), (count, nbytes) in sorted(self.calls.items()):
            row = out.setdefault(kind, {"count": 0, "bytes": 0, "sites": {}})
            row["count"] += count
            row["bytes"] += nbytes
            row["sites"][site] = {"count": count, "bytes": nbytes}
        return out


class Group:
    """A set of ranks (in tile or rank order) with its process group.
    Build it on every rank of the world in the same order
    (``torch.distributed.new_group`` is collective); ``pg`` wraps an
    existing process group instead (the default one for the whole world).

    Every collective of the port goes through :meth:`all_gather` and
    :meth:`all_reduce`, each named by its ``site`` and counted in
    ``counts`` (a :class:`CollectiveCounts`)."""

    def __init__(self, ranks, backend, counts=None, pg=None):
        self.ranks = tuple(ranks)
        self.backend = backend
        self.counts = counts if counts is not None else CollectiveCounts()
        self.pg = pg if pg is not None else dist.new_group(list(self.ranks),
                                                           backend=backend)
        rank = dist.get_rank()
        self.index = self.ranks.index(rank) if rank in self.ranks else None

    @property
    def size(self):
        return len(self.ranks)

    def all_gather(self, x, site="other"):
        """[x of rank r for r in self.ranks], each of x's shape and dtype."""
        src = x.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.pg)
        self.counts.add("all_gather", site,
                        self.size * src.numel() * src.element_size())
        return parts

    def all_reduce(self, x, site="other"):
        """The sum of x over the group (a new tensor)."""
        buf = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, group=self.pg)
        self.counts.add("all_reduce", site, buf.numel() * buf.element_size())
        return buf


def world_group():
    """The whole world's default process group as a :class:`Group`."""
    return Group(range(dist.get_world_size()), dist.get_backend(),
                 pg=dist.group.WORLD)


def _roll(x, shift, group, h_axis):
    """Global cyclic roll by ``shift`` rows of an H-sharded tensor."""
    n, i = group.size, group.index
    H = x.shape[h_axis]
    if shift < 0:  # rows move up: my first s rows go to the previous tile
        s = -shift
        recv = group.all_gather(x.narrow(h_axis, 0, s), "roll")[(i + 1) % n]
        return torch.cat([x.narrow(h_axis, s, H - s), recv], dim=h_axis)
    s = shift      # rows move down: my last s rows go to the next tile
    recv = group.all_gather(x.narrow(h_axis, H - s, s), "roll")[(i - 1) % n]
    return torch.cat([recv, x.narrow(h_axis, 0, H - s)], dim=h_axis)


class _RollH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group, h_axis):
        ctx.args = (shift, group, h_axis)
        return _roll(x, shift, group, h_axis)

    @staticmethod
    def backward(ctx, g):
        shift, group, h_axis = ctx.args
        return _roll(g, -shift, group, h_axis), None, None, None


def global_roll_h(x, shift, group, h_axis=1):
    """``torch.roll(x_global, shift, h_axis)`` of the tile-order
    concatenation of the group's tiles; |shift| below the tile height."""
    if shift == 0:
        return x
    assert abs(shift) < x.shape[h_axis], (shift, x.shape[h_axis])
    return _RollH.apply(x, int(shift), group, h_axis)


class _HaloH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, group, h_axis, wrap, site):
        ctx.args = (halo, group, h_axis, wrap, site)
        n, i = group.size, group.index
        H = x.shape[h_axis]
        edges = torch.cat([x.narrow(h_axis, 0, halo),
                           x.narrow(h_axis, H - halo, halo)], dim=h_axis)
        parts = group.all_gather(edges, site)
        from_prev = parts[(i - 1) % n].narrow(h_axis, halo, halo)  # its bottom
        from_next = parts[(i + 1) % n].narrow(h_axis, 0, halo)     # its top
        if not wrap:
            if i == 0:
                from_prev = torch.zeros_like(from_prev)
            if i == n - 1:
                from_next = torch.zeros_like(from_next)
        return torch.cat([from_prev, x, from_next], dim=h_axis)

    @staticmethod
    def backward(ctx, g):
        halo, group, h_axis, wrap, site = ctx.args
        n, i = group.size, group.index
        H = g.shape[h_axis] - 2 * halo
        g_prev = g.narrow(h_axis, 0, halo)          # belongs to tile i-1
        g_next = g.narrow(h_axis, H + halo, halo)   # belongs to tile i+1
        if not wrap:  # the zero halos of the global edges came from no tile
            if i == 0:
                g_prev = torch.zeros_like(g_prev)
            if i == n - 1:
                g_next = torch.zeros_like(g_next)
        parts = group.all_gather(torch.cat([g_prev, g_next], dim=h_axis),
                                 site)
        dx = g.narrow(h_axis, halo, H).clone()
        # tile i-1's lower halo was my top rows, tile i+1's upper my bottom
        dx.narrow(h_axis, 0, halo).add_(parts[(i - 1) % n].narrow(h_axis, halo, halo))
        dx.narrow(h_axis, H - halo, halo).add_(parts[(i + 1) % n].narrow(h_axis, 0, halo))
        return dx, None, None, None, None, None


def halo_exchange_h(x, halo, group, h_axis=1, wrap=False, site="halo"):
    """x extended by ``halo`` rows of each H-neighbour tile: local H becomes
    H + 2 halo.  The global edges get zero rows unless ``wrap``.  The
    exchanges (forward and backward) are counted under ``site``."""
    assert halo <= x.shape[h_axis], (halo, x.shape[h_axis])
    return _HaloH.apply(x, int(halo), group, h_axis, bool(wrap), site)


class _AllGatherH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, h_axis, site):
        ctx.args = (group, h_axis, x.shape[h_axis], site)
        return torch.cat(group.all_gather(x, site), dim=h_axis)

    @staticmethod
    def backward(ctx, g):
        group, h_axis, H, site = ctx.args
        total = group.all_reduce(g, site)
        return total.narrow(h_axis, group.index * H, H), None, None, None


def all_gather_h(x, group, h_axis=1, site="stripe"):
    """The global H axis: the group's tiles concatenated in tile order (the
    gather, and its backward's all-reduce, counted under ``site``)."""
    return _AllGatherH.apply(x, group, h_axis, site)


class _MeanOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, site):
        ctx.group, ctx.site = group, site
        return group.all_reduce(x, site) / group.size

    @staticmethod
    def backward(ctx, g):
        return (ctx.group.all_reduce(g, ctx.site) / ctx.group.size, None,
                None)


def mean_over_group(x, group, site="moments"):
    """The mean of x over the group's ranks (``lax.pmean``)."""
    return _MeanOverGroup.apply(x, group, site)


def instance_norm_2d_sharded(x, group, eps=1e-5, site="moments"):
    """Affine-free instance norm over the GLOBAL spatial extent of an
    H-sharded [B, H_loc, W, C] tensor: two passes, the mean and then the
    mean of squared deviations, each local mean averaged over the group's
    equal-size tiles.  Returns float32."""
    x32 = x.float()
    m = mean_over_group(x32.mean(dim=(1, 2), keepdim=True), group, site)
    v = mean_over_group(((x32 - m) ** 2).mean(dim=(1, 2), keepdim=True),
                        group, site)
    return (x32 - m) * torch.rsqrt(v + eps)


def global_fourier_rows(pe_global, h_loc, group):
    """This tile's rows of a globally computed [H_glob, ...] row encoding
    (positional embeddings index GLOBAL coordinates)."""
    return pe_global.narrow(0, group.index * h_loc, h_loc)


def split_shift_mask_per_tile(global_mask, n_tiles):
    """[nW, T, T] global shifted-window mask -> [n_tiles, nW / n_tiles, T, T]
    (window rows are contiguous in nW: partition order is row block, column
    block)."""
    nW = global_mask.shape[0]
    assert nW % n_tiles == 0, (nW, n_tiles)
    return global_mask.reshape(n_tiles, nW // n_tiles, *global_mask.shape[1:])


# --------------------------------------------------------------------------- #
# process spawning for tests and the smoke run
# --------------------------------------------------------------------------- #

def free_port():
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(rank, fn, world, backend, port, timeout_s, args):
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
    except BaseException:
        # report here: once this rank leaves, its peers fail on the closed
        # connection and may be the error the parent sees first
        print(f"rank {rank} failed:", file=sys.stderr)
        traceback.print_exc()
        sys.stderr.flush()
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world, backend="gloo", args=(), timeout_s=300):
    """Run ``fn(rank, *args)`` in ``world`` new processes on this host, each
    with the default process group initialised (``backend``, rendezvous on
    tcp://127.0.0.1:<free port>), and wait for all of them.  ``fn`` must be
    importable by name (a module-level function).  If one process raises,
    the others are terminated and the error is raised here; a collective
    that waits on a dead peer gives up after ``timeout_s`` seconds."""
    torch.multiprocessing.spawn(
        _spawned, args=(fn, world, backend, free_port(), timeout_s, args),
        nprocs=world, join=True)
