"""The plain float32 RAFT-Stereo reference of the benchmark (Lipson, Teed,
Deng, "RAFT-Stereo: Multilevel Recurrent Field Transforms for Stereo
Matching", 3DV 2021, arXiv:2109.07547; github.com/princeton-vl/RAFT-Stereo),
and its seeded weights.

It follows upstream's ``core/raft_stereo.py``, ``core/extractor.py``
(``BasicEncoder``, ``MultiBasicEncoder``, ``ResidualBlock``),
``core/update.py`` (``BasicMotionEncoder``, ``ConvGRU``, ``FlowHead``,
``BasicMultiUpdateBlock``) and ``core/corr.py`` (``CorrBlock1D`` with
``bilinear_sampler``) as they run at the default model of
``train_stereo.py``/``evaluate_stereo.py`` (``hidden_dims`` 128 x 3, 3 GRU
levels, ``n_downsample`` 2, 4 correlation levels of radius 4, ``reg``
correlation, batch-norm context, no shared backbone, no slow-fast GRU) in
``test_mode``, NCHW inside as upstream.  Module names are upstream's
``state_dict`` keys.  It imports nothing of the measured package.

Departures from the published code:

- the caller pads: the benchmark pads right and bottom by edge
  replication to 32 (the measured package's ``InputPadder``), where
  upstream's ``InputPadder`` replicates on both sides; both sides of the
  comparison take the same padded input;
- float32 throughout (TF32 off in the caller, ``harness.strict_f32``);
  upstream's ``--mixed_precision`` autocasts the encoders and the update
  block to float16;
- inputs [B, H, W, 3] and the returned maps channel-last, the layout of
  the measured package;
- the forward returns, besides the disparity (the negated x-flow of the
  last iteration, upsampled), what the benchmark's check compares: both
  images' ``fnet`` features, level 0 of the correlation pyramid, the 1/4
  hidden state and the 1/4 disparity after the iterations asked for.

``init_weights`` makes the weights both sides load (upstream's encoder
initialisers, PyTorch's default scale elsewhere; :func:`_scales`), and
sets the batch norms' running statistics from one calibration batch.
``set_fp8`` turns the model into the control: every convolution's input
and weight rounded to float8 e4m3.  ``fault`` plants one of the faults
the check must catch: ``gate`` (each GRU keeps its state where it should
take the candidate: ``z h + (1 - z) q``), ``half_iters`` (half the
iterations) and ``drop_level`` (the coarsest level's lookup read as
zeros)."""

import torch
import torch.nn.functional as F
from torch import nn

from .model import fp8

FAULTS = ("gate", "half_iters", "drop_level")


class _Precision:
    """The control's switch: with ``self.fp8`` a convolution's input and
    weight are rounded to float8 e4m3."""

    fp8 = False

    def lowp(self, *xs):
        return tuple(fp8(x) for x in xs) if self.fp8 else xs


class Conv2d(nn.Conv2d, _Precision):
    def forward(self, x):
        x, w = self.lowp(x, self.weight)
        return self._conv_forward(x, w, self.bias)


def _norm(kind, planes):
    if kind == "batch":
        return nn.BatchNorm2d(planes)
    if kind == "instance":
        return nn.InstanceNorm2d(planes)
    raise ValueError(f"norm {kind!r}: the reference has batch and instance")


class ResidualBlock(nn.Module):
    """``core/extractor.py:ResidualBlock``."""

    def __init__(self, in_planes, planes, norm_fn, stride=1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.relu = nn.ReLU()
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if not (stride == 1 and in_planes == planes):
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class _Encoder(nn.Module):
    """The stem and layers 1-3 that both encoders share."""

    def __init__(self, norm_fn, downsample):
        super().__init__()
        self.norm1 = _norm(norm_fn, 64)
        self.conv1 = Conv2d(3, 64, 7, stride=1 + (downsample > 2), padding=3)
        self.relu1 = nn.ReLU()
        self.in_planes = 64
        self.layer1 = self._make_layer(64, norm_fn, 1)
        self.layer2 = self._make_layer(96, norm_fn, 1 + (downsample > 1))
        self.layer3 = self._make_layer(128, norm_fn, 1 + (downsample > 0))

    def _make_layer(self, dim, norm_fn, stride):
        layers = (ResidualBlock(self.in_planes, dim, norm_fn, stride),
                  ResidualBlock(dim, dim, norm_fn, 1))
        self.in_planes = dim
        return nn.Sequential(*layers)

    def trunk(self, x):
        x = self.relu1(self.norm1(self.conv1(x)))
        return self.layer3(self.layer2(self.layer1(x)))


class BasicEncoder(_Encoder):
    """``fnet``: instance norm, 256 channels at 1/2^downsample."""

    def __init__(self, output_dim, norm_fn, downsample):
        super().__init__(norm_fn, downsample)
        self.conv2 = Conv2d(128, output_dim, 1)

    def forward(self, x):
        return self.conv2(self.trunk(x))


class MultiBasicEncoder(_Encoder):
    """``cnet``: the hidden state and the context at three levels."""

    def __init__(self, output_dim, norm_fn, downsample):
        super().__init__(norm_fn, downsample)
        self.layer4 = self._make_layer(128, norm_fn, 2)
        self.layer5 = self._make_layer(128, norm_fn, 2)
        self.outputs04 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn, 1),
                          Conv2d(128, dim[2], 3, padding=1))
            for dim in output_dim)
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn, 1),
                          Conv2d(128, dim[1], 3, padding=1))
            for dim in output_dim)
        self.outputs16 = nn.ModuleList(Conv2d(128, dim[0], 3, padding=1)
                                       for dim in output_dim)

    def forward(self, x):
        x = self.trunk(x)
        y = self.layer4(x)
        z = self.layer5(y)
        return ([f(x) for f in self.outputs04], [f(y) for f in self.outputs08],
                [f(z) for f in self.outputs16])


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_levels, corr_radius):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1)
        self.convc1 = Conv2d(cor_planes, 64, 1, padding=0)
        self.convc2 = Conv2d(64, 64, 3, padding=1)
        self.convf1 = Conv2d(2, 64, 7, padding=3)
        self.convf2 = Conv2d(64, 64, 3, padding=1)
        self.conv = Conv2d(64 + 64, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


def pool2x(x):
    return F.avg_pool2d(x, 3, stride=2, padding=1)


def interp(x, dest):
    return F.interpolate(x, dest.shape[2:], mode="bilinear",
                         align_corners=True)


class ConvGRU(nn.Module):
    fault = False

    def __init__(self, hidden_dim, input_dim):
        super().__init__()
        self.convz = Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)
        self.convr = Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)
        self.convq = Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)

    def forward(self, h, cz, cr, cq, *x_list):
        x = torch.cat(x_list, dim=1)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        if self.fault:
            return z * h + (1 - z) * q
        return (1 - z) * h + z * q


class FlowHead(nn.Module):
    def __init__(self, input_dim, hidden_dim=256, output_dim=2):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = Conv2d(hidden_dim, output_dim, 3, padding=1)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.conv2(self.relu(self.conv1(x)))


class BasicMultiUpdateBlock(nn.Module):
    """Three GRU levels (``gru08`` at 1/4, ``gru16`` at 1/8, ``gru32`` at
    1/16: upstream's names from RAFT's 1/8 base), each iteration coarse to
    fine, then the flow head and the mask head scaled by 0.25."""

    def __init__(self, hidden_dims, corr_levels, corr_radius, n_downsample):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru08 = ConvGRU(hidden_dims[2], 128 + hidden_dims[1])
        self.gru16 = ConvGRU(hidden_dims[1], hidden_dims[0] + hidden_dims[2])
        self.gru32 = ConvGRU(hidden_dims[0], hidden_dims[1])
        self.flow_head = FlowHead(hidden_dims[2], hidden_dim=256, output_dim=2)
        factor = 2 ** n_downsample
        self.mask = nn.Sequential(
            Conv2d(hidden_dims[2], 256, 3, padding=1), nn.ReLU(),
            Conv2d(256, factor ** 2 * 9, 1, padding=0))

    def forward(self, net, inp, corr, flow):
        net = list(net)
        net[2] = self.gru32(net[2], *inp[2], pool2x(net[1]))
        net[1] = self.gru16(net[1], *inp[1], pool2x(net[0]),
                            interp(net[2], net[1]))
        motion_features = self.encoder(flow, corr)
        net[0] = self.gru08(net[0], *inp[0], motion_features,
                            interp(net[1], net[0]))
        delta_flow = self.flow_head(net[0])
        mask = .25 * self.mask(net[0])
        return net, mask, delta_flow


def bilinear_sampler(img, coords):
    """``core/utils/utils.py:bilinear_sampler``: ``grid_sample`` at pixel
    coordinates, aligned corners, zeros outside."""
    H, W = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (W - 1) - 1
    if H > 1:
        ygrid = 2 * ygrid / (H - 1) - 1
    grid = torch.cat([xgrid, ygrid], dim=-1)
    return F.grid_sample(img, grid, align_corners=True)


class CorrBlock1D:
    """All-pairs correlation along each row, its pyramid (average pooling
    over the second image's columns) and the lookup of ``2 radius + 1``
    taps a level around each pixel's match, by linear interpolation."""

    def __init__(self, fmap1, fmap2, num_levels=4, radius=4,
                 drop_level=False):
        self.num_levels, self.radius = num_levels, radius
        self.drop_level = drop_level
        corr = self.corr(fmap1, fmap2)
        batch, h1, w1, _, w2 = corr.shape
        self.level0 = corr.reshape(batch, h1, w1, w2)
        corr = corr.reshape(batch * h1 * w1, 1, 1, w2)
        self.corr_pyramid = [corr]
        for _ in range(self.num_levels):
            corr = F.avg_pool2d(corr, [1, 2], stride=[1, 2])
            self.corr_pyramid.append(corr)

    def __call__(self, coords):
        r = self.radius
        coords = coords[:, :1].permute(0, 2, 3, 1)
        batch, h1, w1, _ = coords.shape
        out_pyramid = []
        for i in range(self.num_levels):
            corr = self.corr_pyramid[i]
            dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
            dx = dx.view(2 * r + 1, 1)
            x0 = dx + coords.reshape(batch * h1 * w1, 1, 1, 1) / 2 ** i
            y0 = torch.zeros_like(x0)
            corr = bilinear_sampler(corr, torch.cat([x0, y0], dim=-1))
            corr = corr.view(batch, h1, w1, -1)
            if self.drop_level and i == self.num_levels - 1:
                corr = torch.zeros_like(corr)
            out_pyramid.append(corr)
        out = torch.cat(out_pyramid, dim=-1)
        return out.permute(0, 3, 1, 2).contiguous().float()

    @staticmethod
    def corr(fmap1, fmap2):
        B, D, H, W1 = fmap1.shape
        W2 = fmap2.shape[3]
        corr = torch.einsum("aijk,aijh->ajkh", fmap1, fmap2)
        corr = corr.reshape(B, H, W1, 1, W2).contiguous()
        return corr / torch.sqrt(torch.tensor(D).float())


def coords_grid(batch, ht, wd, device):
    coords = torch.meshgrid(torch.arange(ht, device=device),
                            torch.arange(wd, device=device), indexing="ij")
    coords = torch.stack(coords[::-1], dim=0).float()
    return coords[None].repeat(batch, 1, 1, 1)


def _last(x):
    """NCHW -> channel-last."""
    return x.permute(0, 2, 3, 1)


class RAFTStereo(nn.Module):
    """``spec``: a configuration's keys (``RAFT.HIDDEN_DIMS``, ...).
    forward(img1, img2) on [B, H, W, 3] (0..255, H and W multiples of 32)
    returns ``disp`` [B, H, W], and for the check ``fmap1``/``fmap2``
    [B, h, w, 256] (h, w at 1/2^n_downsample), ``corr0`` [B, h, w, w],
    ``hidden`` {t: the 1/4 hidden state [B, h, w, C] after iteration t}
    and ``disp_lowres`` {t: the 1/4 disparity [B, h, w] after iteration
    t}, for the iterations in ``keep_hidden`` and ``keep_disp`` (the state
    after the last iteration for a later one)."""

    def __init__(self, spec):
        super().__init__()
        hidden = list(spec["RAFT.HIDDEN_DIMS"])
        self.n_downsample = spec["RAFT.N_DOWNSAMPLE"]
        self.corr_levels = spec["RAFT.CORR_LEVELS"]
        self.corr_radius = spec["RAFT.CORR_RADIUS"]
        self.valid_iters = spec["RAFT.VALID_ITERS"]
        self.fault = None
        self.cnet = MultiBasicEncoder([hidden, hidden], "batch",
                                      self.n_downsample)
        self.update_block = BasicMultiUpdateBlock(
            hidden, self.corr_levels, self.corr_radius, self.n_downsample)
        self.context_zqr_convs = nn.ModuleList(
            Conv2d(hidden[i], hidden[i] * 3, 3, padding=1) for i in range(3))
        self.fnet = BasicEncoder(256, "instance", self.n_downsample)

    def set_fault(self, name):
        if name is not None and name not in FAULTS:
            raise ValueError(f"no fault {name!r}")
        self.fault = name
        for m in self.modules():
            if isinstance(m, ConvGRU):
                m.fault = name == "gate"
        return self

    def upsample_flow(self, flow, mask):
        N, D, H, W = flow.shape
        factor = 2 ** self.n_downsample
        mask = mask.view(N, 1, 9, factor, factor, H, W)
        mask = torch.softmax(mask, dim=2)
        up_flow = F.unfold(factor * flow, [3, 3], padding=1)
        up_flow = up_flow.view(N, D, 9, 1, 1, H, W)
        up_flow = torch.sum(mask * up_flow, dim=2)
        up_flow = up_flow.permute(0, 1, 4, 2, 5, 3)
        return up_flow.reshape(N, D, factor * H, factor * W)

    def forward(self, img1, img2, iters=None, keep_hidden=(), keep_disp=()):
        iters = self.valid_iters if iters is None else iters
        if self.fault == "half_iters":
            iters //= 2
        image1 = (2 * (img1.permute(0, 3, 1, 2) / 255.0) - 1.0).contiguous()
        image2 = (2 * (img2.permute(0, 3, 1, 2) / 255.0) - 1.0).contiguous()
        cnet_list = self.cnet(image1)
        fmap1, fmap2 = self.fnet(torch.cat([image1, image2])).split(
            image1.shape[0])
        net_list = [torch.tanh(x[0]) for x in cnet_list]
        inp_list = [torch.relu(x[1]) for x in cnet_list]
        inp_list = [list(conv(i).split(conv.out_channels // 3, dim=1))
                    for i, conv in zip(inp_list, self.context_zqr_convs)]
        corr_fn = CorrBlock1D(fmap1.float(), fmap2.float(),
                              self.corr_levels, self.corr_radius,
                              drop_level=self.fault == "drop_level")
        N, _, H, W = net_list[0].shape
        coords0 = coords_grid(N, H, W, img1.device)
        coords1 = coords_grid(N, H, W, img1.device)
        out = {"fmap1": _last(fmap1), "fmap2": _last(fmap2),
               "corr0": corr_fn.level0, "hidden": {}, "disp_lowres": {}}
        for itr in range(iters):
            coords1 = coords1.detach()
            corr = corr_fn(coords1)
            flow = coords1 - coords0
            net_list, up_mask, delta_flow = self.update_block(
                net_list, inp_list, corr, flow)
            delta_flow[:, 1] = 0.0
            coords1 = coords1 + delta_flow
            self._keep(out, itr + 1, net_list[0], coords1 - coords0,
                       keep_hidden, keep_disp)
        for t in keep_hidden:
            out["hidden"].setdefault(t, _last(net_list[0]))
        for t in keep_disp:
            out["disp_lowres"].setdefault(t, -(coords1 - coords0)[:, 0])
        flow_up = self.upsample_flow(coords1 - coords0, up_mask)[:, :1]
        out["disp"] = -flow_up[:, 0]
        return out

    @staticmethod
    def _keep(out, t, hidden, flow, keep_hidden, keep_disp):
        if t in keep_hidden:
            out["hidden"][t] = _last(hidden)
        if t in keep_disp:
            out["disp_lowres"][t] = -flow[:, 0]


def build(spec, device):
    """The reference model of a configuration, on ``device``, float32, in
    eval mode (weights uninitialised)."""
    return RAFTStereo(spec).to(device).eval()


# the seeded draw's scales (``assumed`` in ``benchmark/configs/raft_stereo.json``)
FLOW_BIAS = -0.5  # the flow head's x bias: half a pixel a step at 1/4
FLOW_GAIN = 0.5  # the flow head's last weights at half the default scale
CALIBRATION = (2, 64, 128)  # the batch and size of the norms' calibration


def _scales(model):
    """{name: (std, mean)} of each parameter's seeded draw: in ``fnet`` and
    ``cnet`` upstream's initialisers (convolutions Kaiming normal, fan out;
    norm weights 1, biases 0; conv biases 0); in ``context_zqr_convs`` and
    ``update_block`` PyTorch's default weight scale (the variance of its
    uniform draw, std 1 / sqrt(3 fan_in)) with zero biases, but the flow
    head's last convolution at ``FLOW_GAIN`` times that scale and its x
    bias ``FLOW_BIAS``: the disparity then grows by about half a pixel an
    iteration at 1/4 resolution, pixel by pixel within about a third of
    that, so it stays positive and most lookup taps stay inside the row
    over 32 iterations."""
    out = {}
    for prefix, m in model.named_modules():
        for leaf, p in m.named_parameters(recurse=False):
            name = f"{prefix}.{leaf}"
            encoder = prefix.startswith(("fnet", "cnet"))
            if isinstance(m, nn.BatchNorm2d):
                out[name] = (0.0, 1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                out[name] = (0.0, 0.0)
            elif encoder:
                out[name] = ((2.0 / (p.shape[0] * p[0, 0].numel())) ** 0.5,
                             0.0)
            else:
                gain = FLOW_GAIN if name == "update_block.flow_head.conv2." \
                    "weight" else 1.0
                out[name] = (gain * (1.0 / (3.0 * p[0].numel())) ** 0.5, 0.0)
    return out


@torch.no_grad()
def init_weights(model, seed):
    """Seeded weights, made on the model's device from one generator in
    one draw and scaled leaf by leaf (:func:`_scales`); then the batch
    norms' running statistics: ``cnet`` run once in training mode (each
    norm's running mean and variance those of the batch) on a batch of
    ``CALIBRATION`` frames of uniform noise from the same generator, so
    that each norm's output has about unit variance on such frames."""
    params = list(model.named_parameters())
    scales = _scales(model)
    device = params[0][1].device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(p.numel() for _, p in params), generator=gen,
                       device=device)
    offset = 0
    for name, p in params:
        std, mean = scales[name]
        p.copy_(flat[offset:offset + p.numel()].view_as(p) * std + mean)
        offset += p.numel()
    model.update_block.flow_head.conv2.bias[0] = FLOW_BIAS
    B, H, W = CALIBRATION
    x = torch.rand(B, 3, H, W, generator=gen, device=device) * 2.0 - 1.0
    norms = [m for m in model.cnet.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None  # a cumulative average: one batch's statistics
    model.cnet.train()
    model.cnet(x)
    model.cnet.eval()
    for m in norms:
        m.momentum = 0.1
    return model


def set_fp8(model, on=True):
    for m in model.modules():
        if isinstance(m, _Precision):
            m.fp8 = on
    return model
