"""RAFT-Stereo (Lipson, Teed, Deng, "RAFT-Stereo: Multilevel Recurrent Field
Transforms for Stereo Matching", 3DV 2021, arXiv:2109.07547;
github.com/princeton-vl/RAFT-Stereo) on the port's request path: a second
architecture that ``build_model`` builds under ``MODEL.ARCH raft_stereo``
and ``inference.predict`` serves unchanged.

The model of upstream's ``core/raft_stereo.py`` in ``test_mode``, with
its ``n_gru_layers`` 3 and ``context_norm`` "batch" built in (the only
values the port builds, so neither is an option):

- ``fnet``, RAFT's ``BasicEncoder`` with instance norm, on both images
  (its stem and ``layer1`` at full resolution for ``n_downsample`` 2), 256
  channels at 1/2^n_downsample (1/4);
- ``cnet``, the ``MultiBasicEncoder`` with batch norm (eval mode, running
  statistics) on the left image: a hidden state and a context at 1/4, 1/8
  and 1/16; ``context_zqr_convs`` turn each context into its GRU's z, r
  and q biases once;
- the correlation volume, all pairs along each row, ``<f1, f2> /
  sqrt(C)`` in float32 (upstream's ``reg`` implementation), average-pooled
  over the second image's columns into ``CORR_LEVELS`` levels;
- ``VALID_ITERS`` iterations of: the lookup of ``2 CORR_RADIUS + 1`` taps a
  level around each pixel's match by linear interpolation along the row,
  zeros outside it (``CorrBlock1D``); ``update_block``: the motion encoder,
  the GRUs at 1/16, 1/8 and 1/4 (``gru32``, ``gru16``, ``gru08``), the
  flow head and the mask head scaled by 0.25; the x-flow's update (the
  y-flow stays 0);
- the convex upsampling of the last x-flow over its 3 x 3 neighbours (a
  softmax over 9 weights an output pixel); the disparity is the negated
  x-flow.

Layout and precision: channel-last [B, H, W, C] throughout (the port's
``layers.Conv2d``); convolutions in the compute dtype; the norms, the
volume and its lookup, the GRUs' gates and states, the softmax and every
flow and coordinate in float32.

Module names are upstream's ``state_dict`` keys, so a converted checkpoint
loads, with one exception: a convolution followed by an affine-free
instance norm has no bias, since the norm cancels it (``fnet.conv1`` and
each ``conv1``/``conv2`` of ``fnet``'s residual blocks, which are
``models/backbone.py:ResidualBlock`` unchanged); drop those ``.bias`` keys
of an upstream checkpoint.  A converted checkpoint's ``downsample.0.bias``
loads: the port's residual block keeps it.

Profiler ranges: every op of the forward runs inside exactly one of
``nmrf::raft.encode`` (the input's normalisation, ``fnet``, ``cnet`` and
the z/r/q convolutions), ``nmrf::raft.corr`` (the volume and its
pyramid), ``nmrf::raft.update`` (the iterations; each lookup inside
``nmrf::raft.lookup`` there) and ``nmrf::raft.upsample``; ``iterations``
counts the iterations of the last forward.

On a card without autograd the iterations replay CUDA graphs
(``UpdateGraphs``): one of the lookup, one of ``update_block``'s body.
The loop stays a Python loop and ``update_block`` a module call, so its
hooks fire every iteration, and every tensor passed to or returned from
it is a fresh copy, never a graph's buffer.  The kernels and their inputs
are the eager loop's, so the outputs are its own to the bit.  The graphs
are captured on the first forward at a shape (and at the parameters'
addresses), inside ``nmrf::raft.graph_capture`` within
``nmrf::raft.update``; a forward that finds them held by another call runs
eagerly, as the CPU and any forward that records a gradient do.

Training (upstream's sequence loss) is not ported: ``train()`` raises."""

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from . import graphs
from .backbone import ResidualBlock
from .layers import Conv2d, instance_norm, to_dtype


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm of channel-last [B, H, W, C] with its running statistics
    (eval mode), in float32."""

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return x * scale + (self.bias - self.running_mean * scale)


class BatchResidualBlock(nn.Module):
    """``cnet``'s residual block (upstream ``core/extractor.py:
    ResidualBlock`` with ``norm_fn='batch'``): conv3x3(stride)-BN-relu ->
    conv3x3-BN-relu -> + identity (conv1x1(stride)-BN when the shape
    changes) -> relu."""

    def __init__(self, in_planes, planes, stride=1, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride, padding=1,
                            dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, dtype=dtype)
        self.norm1 = BatchNorm2d(planes)
        self.norm2 = BatchNorm2d(planes)
        self.downsample = None
        if not (stride == 1 and in_planes == planes):
            # upstream registers the norm twice: norm3 and downsample.1
            self.norm3 = BatchNorm2d(planes)
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride, dtype=dtype),
                self.norm3)

    def forward(self, x):
        y = torch.relu(to_dtype(self.norm1(self.conv1(x)), self.dtype))
        y = torch.relu(to_dtype(self.norm2(self.conv2(y)), self.dtype))
        if self.downsample is not None:
            x = to_dtype(self.downsample(x), self.dtype)
        return torch.relu(x + y)


def _strides(downsample):
    """The strides of the stem and of layers 1-3 (upstream's
    ``1 + (downsample > k)``)."""
    return (1 + (downsample > 2), 1, 1 + (downsample > 1),
            1 + (downsample > 0))


class BasicEncoder(nn.Module):
    """``fnet``: the 7x7 stem, three layers of two residual blocks with
    instance norm, a 1x1 output convolution."""

    def __init__(self, output_dim=256, downsample=2, dtype=None):
        super().__init__()
        self.dtype = dtype
        s = _strides(downsample)
        self.conv1 = Conv2d(3, 64, 7, stride=s[0], padding=3, bias=False,
                            dtype=dtype)
        planes = 64
        for i, (dim, stride) in enumerate(zip((64, 96, 128), s[1:]), 1):
            setattr(self, f"layer{i}", nn.Sequential(
                ResidualBlock(planes, dim, stride=stride, dtype=dtype),
                ResidualBlock(dim, dim, dtype=dtype)))
            planes = dim
        self.conv2 = Conv2d(128, output_dim, 1, dtype=dtype)

    def forward(self, x):
        x = torch.relu(to_dtype(instance_norm(self.conv1(x)), self.dtype))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class MultiBasicEncoder(nn.Module):
    """``cnet``: the stem and five layers with batch norm; at 1/4 (after
    ``layer3``), 1/8 and 1/16 the hidden state's and the context's
    outputs (``outputs04``/``08``/``16``, [hidden, context] each)."""

    def __init__(self, hidden_dims, downsample=2, dtype=None):
        super().__init__()
        self.dtype = dtype
        s = _strides(downsample)
        self.norm1 = BatchNorm2d(64)
        self.conv1 = Conv2d(3, 64, 7, stride=s[0], padding=3, dtype=dtype)
        planes = 64
        for i, (dim, stride) in enumerate(
                zip((64, 96, 128, 128, 128), s[1:] + (2, 2)), 1):
            setattr(self, f"layer{i}", nn.Sequential(
                BatchResidualBlock(planes, dim, stride, dtype),
                BatchResidualBlock(dim, dim, 1, dtype)))
            planes = dim

        def head(dim):
            return nn.Sequential(BatchResidualBlock(128, 128, 1, dtype),
                                 Conv2d(128, dim, 3, padding=1, dtype=dtype))

        self.outputs04 = nn.ModuleList(head(hidden_dims[2]) for _ in range(2))
        self.outputs08 = nn.ModuleList(head(hidden_dims[1]) for _ in range(2))
        self.outputs16 = nn.ModuleList(
            Conv2d(128, hidden_dims[0], 3, padding=1, dtype=dtype)
            for _ in range(2))

    def forward(self, x):
        x = torch.relu(to_dtype(self.norm1(self.conv1(x)), self.dtype))
        x = self.layer3(self.layer2(self.layer1(x)))
        y = self.layer4(x)
        z = self.layer5(y)
        return ([f(x) for f in self.outputs04], [f(y) for f in self.outputs08],
                [f(z) for f in self.outputs16])


class BasicMotionEncoder(nn.Module):
    """The lookup's taps and the flow -> 126 features, with the flow
    appended (128)."""

    def __init__(self, corr_levels, corr_radius, dtype=None):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1)
        self.convc1 = Conv2d(cor_planes, 64, 1, dtype=dtype)
        self.convc2 = Conv2d(64, 64, 3, padding=1, dtype=dtype)
        self.convf1 = Conv2d(2, 64, 7, padding=3, dtype=dtype)
        self.convf2 = Conv2d(64, 64, 3, padding=1, dtype=dtype)
        self.conv = Conv2d(64 + 64, 128 - 2, 3, padding=1, dtype=dtype)

    def forward(self, flow, corr):
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=-1)))
        return torch.cat([out, flow], dim=-1)


def _nchw(fn, x, *args, **kwargs):
    """``fn`` of NCHW applied to channel-last x."""
    return fn(x.permute(0, 3, 1, 2), *args, **kwargs).permute(0, 2, 3, 1)


def pool2x(x):
    return _nchw(F.avg_pool2d, x, 3, stride=2, padding=1)


def interp(x, dest):
    return _nchw(F.interpolate, x, dest.shape[1:3], mode="bilinear",
                 align_corners=True)


class ConvGRU(nn.Module):
    """``h' = (1 - z) h + z q`` with 3x3 convolutions for z, r and q over
    [h, x] ([r h, x] for q) plus the context's biases: the convolutions
    in the compute dtype, the gates and the state in float32."""

    def __init__(self, hidden_dim, input_dim, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.convz = Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1,
                            dtype=dtype)
        self.convr = Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1,
                            dtype=dtype)
        self.convq = Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1,
                            dtype=dtype)

    def forward(self, h, cz, cr, cq, *x_list):
        x = x_list[0] if len(x_list) == 1 else torch.cat(x_list, dim=-1)
        x = to_dtype(x, self.dtype)
        hx = torch.cat([to_dtype(h, self.dtype), x], dim=-1)
        z = torch.sigmoid(cz + self.convz(hx))
        r = torch.sigmoid(cr + self.convr(hx))
        q = torch.tanh(cq + self.convq(torch.cat(
            [to_dtype(r * h, self.dtype), x], dim=-1)))
        return torch.lerp(h, q, z)


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256, output_dim=2,
                 dtype=None):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3, padding=1, dtype=dtype)
        self.conv2 = Conv2d(hidden_dim, output_dim, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


class BasicMultiUpdateBlock(nn.Module):
    """One iteration's update of the three hidden states, coarse to fine
    (upstream's names from RAFT's 1/8 base: ``gru08`` runs at 1/4,
    ``gru16`` at 1/8, ``gru32`` at 1/16), then the flow head and the mask
    head (scaled by 0.25) on the 1/4 state.  Returns (states, mask,
    delta flow); with ``replay`` (the request's ``UpdateGraphs``, whose
    static context biases hold ``inp``) from a replay of its graph."""

    def __init__(self, hidden_dims, corr_levels, corr_radius, n_downsample,
                 dtype=None):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius, dtype)
        self.gru08 = ConvGRU(hidden_dims[2], 128 + hidden_dims[1], dtype)
        self.gru16 = ConvGRU(hidden_dims[1], hidden_dims[0] + hidden_dims[2],
                             dtype)
        self.gru32 = ConvGRU(hidden_dims[0], hidden_dims[1], dtype)
        self.flow_head = FlowHead(hidden_dims[2], 256, 2, dtype)
        factor = 2 ** n_downsample
        self.mask = nn.Sequential(
            Conv2d(hidden_dims[2], 256, 3, padding=1, dtype=dtype), nn.ReLU(),
            Conv2d(256, factor ** 2 * 9, 1, dtype=dtype))

    def forward(self, net, inp, corr, flow, replay=None):
        if replay is not None:
            return replay.update(net, corr, flow)
        net = list(net)
        net[2] = self.gru32(net[2], *inp[2], pool2x(net[1]))
        net[1] = self.gru16(net[1], *inp[1], pool2x(net[0]),
                            interp(net[2], net[1]))
        motion = self.encoder(flow, corr)
        net[0] = self.gru08(net[0], *inp[0], motion, interp(net[1], net[0]))
        return net, 0.25 * self.mask(net[0]), self.flow_head(net[0])


class CorrBlock1D(nn.Module):
    """The correlation pyramid and its lookup (upstream ``core/corr.py:
    CorrBlock1D``), float32.  The pyramid is one [B, h, w1, sum of level
    widths] tensor, the levels side by side, so that one gather reads the
    taps of every level."""

    def __init__(self, num_levels=4, radius=4):
        super().__init__()
        self.num_levels, self.radius = num_levels, radius

    def forward(self, fmap1, fmap2):
        """fmap1, fmap2: [B, h, w, C] -> the pyramid [B, h, w, W], level 0
        its first w columns."""
        B, h, w, C = fmap1.shape
        corr = torch.matmul(fmap1.float(), fmap2.float().transpose(-1, -2)) \
            / math.sqrt(C)
        levels = [corr]
        for _ in range(1, self.num_levels):
            c = levels[-1]
            levels.append(F.avg_pool1d(c.reshape(-1, 1, c.shape[-1]), 2, 2)
                          .reshape(B, h, w, -1))
        return torch.cat(levels, dim=-1)

    def widths(self, w):
        out = [w]
        for _ in range(1, self.num_levels):
            out.append(out[-1] // 2)
        return out

    def grid(self, w, device):
        """The lookup's constants for a first image of width ``w``: each
        level's width and first column in the pyramid, its scale, and the
        column offsets of its taps (made once a forward)."""
        widths = self.widths(w)
        L, r = self.num_levels, self.radius
        return (torch.tensor(widths, device=device).view(L, 1),
                torch.tensor([sum(widths[:i]) for i in range(L)],
                             device=device).view(L, 1),
                torch.tensor([0.5 ** i for i in range(L)], device=device),
                torch.arange(-r, r + 2, device=device))

    def lookup(self, pyramid, coords, grid):
        """coords [B, h, w]: each pixel's match (column) in the second
        image -> [B, h, w, levels x (2 radius + 1)]: at level i the row at
        coords / 2^i + d, d = -radius .. radius, linearly interpolated
        between whole columns, a column outside the level read as 0.  The
        taps of a pixel share their fraction, so each level gathers the 2
        radius + 2 whole columns around them once.  ``grid``: ``grid(w,
        device)``."""
        B, h, w = coords.shape
        width, start, scale, offsets = grid
        centre = coords.unsqueeze(-1) * scale                   # [B,h,w,L]
        left = torch.floor(centre)
        frac = (centre - left).unsqueeze(-1)
        cols = left.long().unsqueeze(-1) + offsets              # [B,h,w,L,2r+2]
        inside = (cols >= 0) & (cols < width)
        taps = torch.gather(pyramid, -1, torch.where(
            inside, cols + start, 0).reshape(B, h, w, -1))
        taps = torch.where(inside, taps.view(inside.shape), 0.0)
        return torch.lerp(taps[..., :-1], taps[..., 1:], frac).reshape(
            B, h, w, -1)


def convex_upsample(flow, mask, factor):
    """flow [B, h, w] (float32), mask [B, h, w, 9 factor^2] -> [B, factor
    h, factor w]: each output pixel a softmax-weighted combination of the
    3 x 3 neighbours (zeros beyond the edge) of factor x flow (upstream
    ``RAFTStereo.upsample_flow``)."""
    B, h, w = flow.shape
    weights = torch.softmax(mask.float().view(B, h, w, 9, factor, factor),
                            dim=3)
    nbrs = F.unfold((factor * flow).unsqueeze(1), 3, padding=1)
    nbrs = nbrs.view(B, 9, h, w).permute(0, 2, 3, 1)
    up = (weights * nbrs[..., None, None]).sum(dim=3)        # [B,h,w,f,f]
    return up.permute(0, 1, 3, 2, 4).reshape(B, factor * h, factor * w)


class UpdateGraphs:
    """The update loop's CUDA graphs at one shape, over static buffers:
    ``lookup(flow)`` replays the lookup at ``columns + flow`` and
    ``update(net, corr, flow)`` the body of ``update_block``; each copies
    its per-iteration inputs in and returns fresh copies of its outputs.
    ``load(pyramid, inp)`` copies in what a request holds constant (the
    pyramid and the context biases), once a request; the lookup's
    constants (the columns and ``CorrBlock1D.grid``) are made once, at
    capture.  Both graphs share one memory pool and replay in the order
    they were captured."""

    def __init__(self, model, pyramid, net, inp):
        B, h, w, _ = pyramid.shape
        device = pyramid.device
        pool = torch.cuda.graph_pool_handle()
        self.pyramid = graphs.static_like(pyramid)
        self.inp = [[graphs.static_like(t) for t in level] for level in inp]
        self.flow = torch.zeros((B, h, w), device=device)
        # kept for the life of the graph, which reads them
        self._consts = (torch.arange(w, device=device, dtype=torch.float32),
                        model.corr_block.grid(w, device))
        columns, grid = self._consts
        self._lookup = graphs.Captured(
            lambda p, f: model.corr_block.lookup(p, columns + f, grid),
            [self.pyramid, self.flow], pool)
        self.update_in = [graphs.static_like(t) for t in net] + [
            graphs.static_like(self._lookup.outputs),
            torch.zeros((B, h, w, 2), device=device)]
        self._update = graphs.Captured(
            lambda n0, n1, n2, corr, flow: model.update_block.forward(
                [n0, n1, n2], self.inp, corr, flow), self.update_in, pool)

    def load(self, pyramid, inp):
        graphs.copy_in([self.pyramid, *(t for level in self.inp
                                        for t in level)],
                       [pyramid, *(t for level in inp for t in level)])

    def lookup(self, flow):
        self.flow.copy_(flow)
        return graphs.copy_out([self._lookup.replay()])[0]

    def update(self, net, corr, flow):
        graphs.copy_in(self.update_in, [*net, corr, flow])
        net, mask, delta = self._update.replay()
        *net, mask, delta = graphs.copy_out([*net, mask, delta])
        return net, mask, delta


class RAFTStereo(nn.Module):
    """forward(img1, img2): [B, H, W, 3] float32 0..255, H and W multiples
    of ``divis_by``, -> {"disp": [B, H, W] float32, "disp_lowres": the
    disparity after the last iteration at 1/2^n_downsample}."""

    divis_by = 32  # upstream's InputPadder

    def __init__(self, hidden_dims=(128, 128, 128), n_downsample=2,
                 corr_levels=4, corr_radius=4, valid_iters=32, dtype=None):
        super().__init__()
        if self.divis_by % 2 ** (n_downsample + 2):
            raise ValueError(f"RAFT.N_DOWNSAMPLE {n_downsample}: the 1/16 "
                             f"level does not divide {self.divis_by}")
        self.n_downsample, self.valid_iters = n_downsample, valid_iters
        self.iterations = 0
        self.cnet = MultiBasicEncoder(hidden_dims, n_downsample, dtype)
        self.update_block = BasicMultiUpdateBlock(
            hidden_dims, corr_levels, corr_radius, n_downsample, dtype)
        self.context_zqr_convs = nn.ModuleList(
            Conv2d(d, 3 * d, 3, padding=1, dtype=dtype) for d in hidden_dims)
        self.fnet = BasicEncoder(256, n_downsample, dtype)
        self.corr_block = CorrBlock1D(corr_levels, corr_radius)
        self.update_graphs = graphs.GraphCache("nmrf::raft.graph_capture")

    def train(self, mode=True):
        if mode:
            raise NotImplementedError(
                "RAFT-Stereo's training (its sequence loss) is not ported; "
                "the port serves it in eval mode")
        return super().train(False)

    def encode(self, img1, img2):
        """(states, context biases, fmap1, fmap2)."""
        x = 2 * (torch.cat([img1, img2]) / 255.0) - 1.0
        B = img1.shape[0]
        cnet = self.cnet(x[:B])
        fmap1, fmap2 = self.fnet(x).split(B)
        net = [torch.tanh(level[0].float()) for level in cnet]
        inp = [conv(torch.relu(level[1])).float().split(
                   conv.out_channels // 3, dim=-1)
               for level, conv in zip(cnet, self.context_zqr_convs)]
        return net, inp, fmap1, fmap2

    def _loop_graphs(self, pyramid, net, inp):
        """A ``with`` context that gives the loop's ``UpdateGraphs`` at this
        shape, or None where the loop runs eagerly: off a card, with a
        gradient recorded, inside a capture, or while another call holds
        them."""
        if not graphs.capturable(pyramid):
            return contextlib.nullcontext()
        tensors = [pyramid, *net, *(t for level in inp for t in level)]
        key = (pyramid.device,
               tuple((t.shape, t.stride(), t.dtype) for t in tensors),
               tuple((p.data_ptr(), p.dtype)
                     for p in self.update_block.parameters()))
        return self.update_graphs.hold(
            key, lambda: UpdateGraphs(self, pyramid, net, inp))

    def forward(self, img1, img2):
        with record_function("nmrf::raft.encode"):
            net, inp, fmap1, fmap2 = self.encode(img1, img2)
        with record_function("nmrf::raft.corr"):
            pyramid = self.corr_block(fmap1, fmap2)
        with record_function("nmrf::raft.update"), \
                self._loop_graphs(pyramid, net, inp) as loop:
            B, h, w, _ = fmap1.shape
            if loop is None:
                columns = torch.arange(w, device=fmap1.device,
                                       dtype=torch.float32)
                grid = self.corr_block.grid(w, fmap1.device)

                def lookup(flow):
                    return self.corr_block.lookup(pyramid, columns + flow,
                                                  grid)
            else:
                loop.load(pyramid, inp)
                lookup = loop.lookup
            flow = fmap1.new_zeros((B, h, w), dtype=torch.float32)
            zero = torch.zeros_like(flow)
            self.iterations = 0
            for _ in range(self.valid_iters):
                with record_function("nmrf::raft.lookup"):
                    corr = lookup(flow)
                net, mask, delta = self.update_block(
                    net, inp, corr, torch.stack([flow, zero], dim=-1),
                    replay=loop)
                flow = flow + delta[..., 0]
                self.iterations += 1
        with record_function("nmrf::raft.upsample"):
            disp = -convex_upsample(flow, mask, 2 ** self.n_downsample)
            return {"disp": disp, "disp_lowres": -flow}


def init_weights(model, seed):
    """Seeded random weights: every convolution Kaiming normal (fan out),
    biases 0, batch norms the identity (weight 1, bias 0, running mean 0
    and variance 1).  A stand-in: load trained (or the benchmark's seeded)
    weights with ``load_state_dict``."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv2d):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm2d):
                m.reset_parameters()
    return model


def build_raft_stereo(cfg, dtype):
    """The model of a config tree's ``RAFT`` node, its weights from
    ``cfg.SEED`` (on the CPU)."""
    r = cfg.RAFT
    model = RAFTStereo(hidden_dims=r.HIDDEN_DIMS, n_downsample=r.N_DOWNSAMPLE,
                       corr_levels=r.CORR_LEVELS, corr_radius=r.CORR_RADIUS,
                       valid_iters=r.VALID_ITERS, dtype=dtype)
    return init_weights(model, cfg.SEED)
