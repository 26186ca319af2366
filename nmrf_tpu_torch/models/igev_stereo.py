"""IGEV-Stereo (Xu, Wang, Ding, Yang, "Iterative Geometry Encoding Volume for
Stereo Matching", CVPR 2023, arXiv:2303.06615; github.com/gangweiX/IGEV) on
the port's request path: a third architecture that ``build_model`` builds
under ``MODEL.ARCH igev_stereo`` and ``inference.predict`` serves
unchanged.

The model of upstream's ``core/igev_stereo.py`` in ``test_mode``, with
``n_gru_layers`` 3 and no slow-fast GRU (the only values the port builds):

- ``feature``: MobileNetV2's trunk (``models/mobilenet.py``, timm's
  ``mobilenetv2_100`` blocks 0-5) and its decoder (``deconv32_16``,
  ``deconv16_8``, ``deconv8_4``: transposed convolutions with instance norm,
  each joined to the trunk's map), giving 48/64/192/160 channels at 1/4,
  1/8, 1/16 and 1/32; ``stem_2``/``stem_4`` (32 channels at 1/2, 48 at
  1/4); the 1/4 features the decoder's and ``stem_4``'s, 96 channels; the
  matching features ``desc(conv(.))``.  Both images run as one batch (the
  instance norms are per image, the batch norms use running statistics);
- the geometry encoding volume (GEV): the group-wise correlation of the
  matching features, 8 groups over ``MAX_DISP / 4`` disparities
  (``ops/correlation.py``), ``corr_stem``, ``corr_feature_att`` and
  ``cost_agg`` (a 3-D hourglass gated by the left image's features at
  1/4 to 1/32), then ``classifier``, a softmax over the disparities and
  their expectation: the starting disparity;
- ``cnet`` and ``context_zqr_convs``: RAFT-Stereo's (``raft_stereo.py``);
- two pyramids of ``CORR_LEVELS`` levels: the GEV average-pooled by 2 over
  the disparities, and the all-pairs product <f1, f2> of the matching
  features along each row (no 1/sqrt(C)), pooled over the second image's
  columns;
- ``VALID_ITERS`` iterations of the combined lookup (per level 2
  ``CORR_RADIUS`` + 1 taps of the GEV's 8 channels at disp / 2^i + dx and
  of the all-pairs volume at x / 2^i - disp / 2^i + dx, linear along the
  row, zeros beyond it) and ``update_block`` (RAFT-Stereo's GRUs under
  IGEV's names, its own motion encoder and heads); ``disp += delta``;
- ``upsample_disp`` once: ``spx_2_gru`` (a transposed convolution of
  ``mask_feat_4`` joined to ``stem_2``'s map), ``spx_gru`` to 9 weights a
  full-resolution pixel, a softmax over them, and ``context_upsample`` of
  4 x disp over its 3 x 3 neighbours.

Layout and precision follow ``raft_stereo.py``: channel-last ([B, H, W, C];
3-D [B, D, H, W, C]); convolutions in the compute dtype; the norms, the
softmax and the starting disparity, both pyramids and their lookup, the
GRUs' gates and states, and every disparity in float32.

Module names are upstream's ``state_dict`` keys (``feature.conv_stem``,
``feature.block0`` .. ``block4``, ``cost_agg.conv1``,
``update_block.gru04``, ...), so a converted checkpoint loads; as upstream,
every ``BasicConv`` holds its batch norm even where it runs none
(``cost_agg.conv1_up.bn``), and ``spx``, ``spx_2`` and ``spx_4`` (training's
upsampling of the starting disparity) are held and never run.

Profiler ranges: every op of the forward runs inside exactly one of
``nmrf::igev.features`` (the input's normalisation, ``feature``, the stems,
``conv``/``desc``; both images), ``nmrf::igev.volume`` (the group-wise
volume through the starting disparity), ``nmrf::igev.context`` (``cnet``,
the z/r/q convolutions), ``nmrf::igev.corr`` (the all-pairs volume and both
pyramids), ``nmrf::igev.update`` (the iterations; each lookup inside
``nmrf::igev.lookup`` there) and ``nmrf::igev.upsample``; ``iterations``
counts the iterations of the last forward.

On a card without autograd the iterations replay the CUDA graphs of RAFT-
Stereo's loop (``graphs.UpdateGraphs``: one of the lookup, one of
``update_block``'s body; both pyramids and the context biases copied in
once a request), captured on the first forward at a shape inside
``nmrf::igev.graph_capture`` within ``nmrf::igev.update``.  Hooks on
``update_block`` fire every iteration and no tensor handed out is a
graph's buffer.  The features, volume and context stages run eagerly.

Training (the smooth-L1 loss of the starting disparity and the sequence
loss) is not ported: ``train()`` raises."""

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from . import graphs, mobilenet
from ..ops.correlation import correlation_volume
from .layers import (BatchNorm2d, BatchNorm3d, Conv2d, Conv3d,
                     ConvTranspose2d, ConvTranspose3d, instance_norm_2d,
                     to_dtype)
from .raft_stereo import (BasicMotionEncoder, BasicMultiUpdateBlock,
                          CorrBlock1D, FlowHead, MultiBasicEncoder,
                          hidden_and_context, init_weights, regroup)

GROUPS = 8  # the group-wise volume's groups, and the GEV's channels
SLOPE = 0.01  # LeakyReLU's negative slope (upstream's nn.LeakyReLU())

_CONVS = {(False, False): Conv2d, (True, False): ConvTranspose2d,
          (False, True): Conv3d, (True, True): ConvTranspose3d}


class BasicConv(nn.Module):
    """Upstream's ``BasicConv`` (``norm`` "batch") and ``BasicConv_IN``
    ("instance", affine-free): a convolution without bias (transposed with
    ``deconv``, 3-D with ``is_3d``), the norm where ``norm_on``, then
    LeakyReLU 0.01 where ``relu``.  A batch-norm block holds its norm (as
    ``bn``) even where it runs none, as upstream."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 norm="batch", norm_on=True, relu=True, deconv=False,
                 is_3d=False, dtype=None):
        super().__init__()
        self.dtype, self.relu = dtype, relu
        self.norm = norm if norm_on else None
        self.conv = _CONVS[deconv, is_3d](in_ch, out_ch, kernel_size,
                                          stride=stride, padding=padding,
                                          bias=False, dtype=dtype)
        if norm == "batch":
            self.bn = (BatchNorm3d if is_3d else BatchNorm2d)(out_ch)

    def forward(self, x):
        x = self.conv(x)
        if self.norm == "batch":
            x = to_dtype(self.bn(x), self.dtype)
        elif self.norm == "instance":
            x = to_dtype(instance_norm_2d(x), self.dtype)
        return F.leaky_relu(x, SLOPE) if self.relu else x


class Conv2x(nn.Module):
    """Upstream's ``Conv2x`` (``norm`` "batch") and ``Conv2x_IN``
    ("instance") as IGEV-Stereo builds them (2-D, ``deconv``, concatenating,
    ``keep_concat``): ``conv1``, a 4 x 4 stride-2 transposed convolution to
    ``rem``'s size (inputs padded to 32: upstream's nearest resize never
    runs), joined to ``rem``, and ``conv2`` (3 x 3, twice ``out_ch``)."""

    def __init__(self, in_ch, out_ch, norm="batch", dtype=None):
        super().__init__()
        self.conv1 = BasicConv(in_ch, out_ch, 4, 2, 1, norm, deconv=True,
                               dtype=dtype)
        self.conv2 = BasicConv(2 * out_ch, 2 * out_ch, 3, 1, 1, norm,
                               dtype=dtype)

    def forward(self, x, rem):
        return self.conv2(torch.cat([self.conv1(x), rem], dim=-1))


class InstanceNormReLU(nn.Module):
    """The affine-free instance norm (float32) and ReLU that end upstream's
    stems, in the compute dtype."""

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype

    def forward(self, x):
        return torch.relu(to_dtype(instance_norm_2d(x), self.dtype))


def _stem(in_ch, out_ch, dtype):
    """``stem_2``/``stem_4``: a stride-2 ``BasicConv_IN``, a 3 x 3
    convolution without bias, instance norm and ReLU (the convolutions at
    upstream's indices 0 and 1)."""
    return nn.Sequential(
        BasicConv(in_ch, out_ch, 3, 2, 1, "instance", dtype=dtype),
        Conv2d(out_ch, out_ch, 3, padding=1, bias=False, dtype=dtype),
        InstanceNormReLU(dtype))


class Feature(nn.Module):
    """MobileNetV2's trunk (``conv_stem``, ``bn1`` with ReLU6, ``block0`` ..
    ``block4`` = timm's stages 0, 1, 2, 3-4, 5) and upstream's decoder ->
    [x4 (48), x8 (64), x16 (192), x32 (160)] channel-last."""

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv_stem = Conv2d(3, mobilenet.STEM, 3, stride=2, padding=1,
                                bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(mobilenet.STEM)
        s = mobilenet.stages(dtype)
        self.block0 = nn.Sequential(s[0])
        self.block1 = nn.Sequential(s[1])
        self.block2 = nn.Sequential(s[2])
        self.block3 = nn.Sequential(s[3], s[4])
        self.block4 = nn.Sequential(s[5])
        self.deconv32_16 = Conv2x(160, 96, "instance", dtype)
        self.deconv16_8 = Conv2x(192, 32, "instance", dtype)
        self.deconv8_4 = Conv2x(64, 24, "instance", dtype)
        self.conv4 = BasicConv(48, 48, 3, 1, 1, "instance", dtype=dtype)

    def forward(self, x):
        x = F.relu6(to_dtype(self.bn1(self.conv_stem(x)), self.dtype))
        x2 = self.block0(x)
        x4 = self.block1(x2)
        x8 = self.block2(x4)
        x16 = self.block3(x8)
        x32 = self.block4(x16)
        x16 = self.deconv32_16(x32, x16)
        x8 = self.deconv16_8(x16, x8)
        x4 = self.conv4(self.deconv8_4(x8, x4))
        return [x4, x8, x16, x32]


class FeatureAtt(nn.Module):
    """A volume gated by an image's features: ``sigmoid(feat_att(feat))``
    (a 1 x 1 ``BasicConv`` to half the channels, a 1 x 1 convolution to the
    volume's) times the volume [B, D, H, W, C] at every disparity."""

    def __init__(self, cv_ch, feat_ch, dtype=None):
        super().__init__()
        self.feat_att = nn.Sequential(
            BasicConv(feat_ch, feat_ch // 2, 1, dtype=dtype),
            Conv2d(feat_ch // 2, cv_ch, 1, dtype=dtype))

    def forward(self, cv, feat):
        return torch.sigmoid(self.feat_att(feat)).unsqueeze(1) * cv


def _conv3(in_ch, out_ch, kernel_size=3, stride=1, padding=1, dtype=None,
           **kwargs):
    return BasicConv(in_ch, out_ch, kernel_size, stride, padding,
                     is_3d=True, dtype=dtype, **kwargs)


class Hourglass(nn.Module):
    """Upstream's ``hourglass(c)``: 2c/4c/6c channels at strides 2/4/8 of
    the volume, each level gated by the features at 1/8, 1/16 and 1/32 on
    the way down and at 1/16 and 1/8 on the way up (``agg_0``, ``agg_1``
    after joining the skip), ``conv1_up`` to 8 channels at the volume's
    size, with no norm and no activation."""

    def __init__(self, c, dtype=None):
        super().__init__()

        def down(i, o):
            return nn.Sequential(_conv3(i, o, stride=2, dtype=dtype),
                                 _conv3(o, o, dtype=dtype))

        def up(i, o, **kwargs):
            return _conv3(i, o, 4, 2, 1, deconv=True, dtype=dtype, **kwargs)

        def agg(i, o):
            return nn.Sequential(_conv3(i, o, 1, 1, 0, dtype=dtype),
                                 _conv3(o, o, dtype=dtype),
                                 _conv3(o, o, dtype=dtype))

        self.conv1 = down(c, 2 * c)
        self.conv2 = down(2 * c, 4 * c)
        self.conv3 = down(4 * c, 6 * c)
        self.conv3_up = up(6 * c, 4 * c)
        self.conv2_up = up(4 * c, 2 * c)
        self.conv1_up = up(2 * c, GROUPS, norm_on=False, relu=False)
        self.agg_0 = agg(8 * c, 4 * c)
        self.agg_1 = agg(4 * c, 2 * c)
        self.feature_att_8 = FeatureAtt(2 * c, 64, dtype)
        self.feature_att_16 = FeatureAtt(4 * c, 192, dtype)
        self.feature_att_32 = FeatureAtt(6 * c, 160, dtype)
        self.feature_att_up_16 = FeatureAtt(4 * c, 192, dtype)
        self.feature_att_up_8 = FeatureAtt(2 * c, 64, dtype)

    def forward(self, x, features):
        conv1 = self.feature_att_8(self.conv1(x), features[1])
        conv2 = self.feature_att_16(self.conv2(conv1), features[2])
        conv3 = self.feature_att_32(self.conv3(conv2), features[3])
        conv2 = self.agg_0(torch.cat([self.conv3_up(conv3), conv2], dim=-1))
        conv2 = self.feature_att_up_16(conv2, features[2])
        conv1 = self.agg_1(torch.cat([self.conv2_up(conv2), conv1], dim=-1))
        conv1 = self.feature_att_up_8(conv1, features[1])
        return self.conv1_up(conv1)


class UpdateBlock(BasicMultiUpdateBlock):
    """IGEV-Stereo's ``BasicMultiUpdateBlock``: RAFT-Stereo's three GRUs
    under the names ``gru04``, ``gru08``, ``gru16``, its motion encoder of
    the ``corr_planes`` taps and the 1-channel disparity (``convd1``,
    ``convd2``), and its heads: ``mask_feat_4`` (3 x 3 to 32 channels,
    ReLU) and ``disp_head`` (1 channel).  Returns (states, mask_feat_4,
    delta disparity)."""

    levels = ("gru04", "gru08", "gru16")

    def __init__(self, hidden_dims, corr_planes, dtype=None):
        nn.Module.__init__(self)
        self.encoder = BasicMotionEncoder(corr_planes, 1, "convd", dtype)
        self.add_grus(hidden_dims, dtype)
        self.disp_head = FlowHead(hidden_dims[2], 256, 1, dtype)
        self.mask_feat_4 = nn.Sequential(
            Conv2d(hidden_dims[2], 32, 3, padding=1, dtype=dtype), nn.ReLU())

    def heads(self, h):
        return self.mask_feat_4(h), self.disp_head(h)


class GeometryVolume(nn.Module):
    """The GEV's pyramid and its lookup (upstream ``core/geometry.py:
    Combined_Geo_Encoding_Volume``'s ``geo_volume_pyramid``), float32: one
    [B, h, w, sum of level depths, C] tensor, the levels side by side along
    the disparities (each the one before average-pooled by 2), so that one
    gather reads every level's taps, C channels a tap."""

    def __init__(self, num_levels=2, radius=4):
        super().__init__()
        self.num_levels, self.radius = num_levels, radius

    def forward(self, geo):
        """geo [B, D, h, w, C] -> the pyramid [B, h, w, sum D_i, C]."""
        levels = [geo.float().permute(0, 2, 3, 1, 4)]
        for _ in range(1, self.num_levels):
            c = levels[-1]
            d = c.shape[3] // 2
            levels.append(c[:, :, :, :2 * d].unflatten(3, (d, 2)).mean(4))
        return torch.cat(levels, dim=3)

    def depths(self, d):
        out = [d]
        for _ in range(1, self.num_levels):
            out.append(out[-1] // 2)
        return out

    def grid(self, d, device):
        """The lookup's constants for a volume of ``d`` disparities (as
        ``CorrBlock1D.grid``)."""
        depths = self.depths(d)
        L, r = self.num_levels, self.radius
        return (torch.tensor(depths, device=device).view(L, 1),
                torch.tensor([sum(depths[:i]) for i in range(L)],
                             device=device).view(L, 1),
                torch.tensor([0.5 ** i for i in range(L)], device=device),
                torch.arange(-r, r + 2, device=device))

    def lookup(self, pyramid, disp, grid):
        """disp [B, h, w] -> [B, h, w, levels, C, 2 radius + 1]: at level i
        the volume at disp / 2^i + d, d = -radius .. radius, linearly
        interpolated between whole disparities, one outside the level read
        as 0."""
        B, h, w = disp.shape
        C = pyramid.shape[-1]
        depth, start, scale, offsets = grid
        centre = disp.unsqueeze(-1) * scale                      # [B,h,w,L]
        left = torch.floor(centre)
        frac = (centre - left)[..., None, None]
        cols = left.long().unsqueeze(-1) + offsets          # [B,h,w,L,2r+2]
        inside = (cols >= 0) & (cols < depth)
        idx = torch.where(inside, cols + start, 0).reshape(B, h, w, -1, 1)
        taps = torch.gather(pyramid, 3, idx.expand(-1, -1, -1, -1, C))
        taps = torch.where(inside.unsqueeze(-1),
                           taps.view(*inside.shape, C), 0.0)
        out = torch.lerp(taps[:, :, :, :, :-1], taps[:, :, :, :, 1:], frac)
        return out.transpose(-1, -2)


def context_upsample(disp, weights):
    """disp [B, h, w] (float32), weights [B, 4h, 4w, 9] -> [B, 4h, 4w]:
    each output pixel the weighted sum of the 3 x 3 neighbours (zeros
    beyond the edge) of its nearest low-resolution pixel (upstream
    ``core/submodule.py:context_upsample``)."""
    B, h, w = disp.shape
    f = weights.shape[1] // h
    nbrs = F.unfold(disp.unsqueeze(1), 3, padding=1).view(B, 9, h, w)
    nbrs = nbrs.permute(0, 2, 3, 1)[:, :, None, :, None]      # [B,h,1,w,1,9]
    up = (weights.view(B, h, f, w, f, 9) * nbrs).sum(-1)
    return up.reshape(B, f * h, f * w)


class IGEVStereo(nn.Module):
    """forward(img1, img2): [B, H, W, 3] float32 0..255, H and W multiples
    of ``divis_by``, -> {"disp": [B, H, W] float32, "disp_lowres": the
    disparity after the last iteration at 1/4, "init_disp": the starting
    disparity at 1/4}."""

    divis_by = 32  # upstream's InputPadder

    def __init__(self, hidden_dims=(128, 128, 128), n_downsample=2,
                 corr_levels=2, corr_radius=4, valid_iters=32, max_disp=192,
                 dtype=None):
        super().__init__()
        if n_downsample != 2:
            raise ValueError(f"RAFT.N_DOWNSAMPLE {n_downsample}: "
                             "IGEV-Stereo's volume and upsampling are at "
                             "1/4 (2)")
        if max_disp % 32:
            raise ValueError(f"IGEV.MAX_DISP {max_disp}: the hourglass halves "
                             "the volume's MAX_DISP / 4 disparities three "
                             "times (a multiple of 32)")
        self.valid_iters, self.max_disp = valid_iters, max_disp
        self.iterations = 0
        corr_planes = corr_levels * (2 * corr_radius + 1) * (GROUPS + 1)
        self.cnet = MultiBasicEncoder(hidden_dims, n_downsample, dtype)
        self.update_block = UpdateBlock(hidden_dims, corr_planes, dtype)
        self.context_zqr_convs = nn.ModuleList(
            Conv2d(d, 3 * d, 3, padding=1, dtype=dtype) for d in hidden_dims)
        self.feature = Feature(dtype)
        self.stem_2 = _stem(3, 32, dtype)
        self.stem_4 = _stem(32, 48, dtype)
        self.spx = nn.Sequential(ConvTranspose2d(64, 9, 4, 2, 1, dtype=dtype))
        self.spx_2 = Conv2x(24, 32, "instance", dtype)
        self.spx_4 = nn.Sequential(
            BasicConv(96, 24, 3, 1, 1, "instance", dtype=dtype),
            Conv2d(24, 24, 3, padding=1, bias=False, dtype=dtype),
            InstanceNormReLU(dtype))
        self.spx_2_gru = Conv2x(32, 32, "batch", dtype)
        self.spx_gru = nn.Sequential(
            ConvTranspose2d(64, 9, 4, 2, 1, dtype=dtype))
        self.conv = BasicConv(96, 96, 3, 1, 1, "instance", dtype=dtype)
        self.desc = Conv2d(96, 96, 1, dtype=dtype)
        self.corr_stem = _conv3(GROUPS, GROUPS, dtype=dtype)
        self.corr_feature_att = FeatureAtt(GROUPS, 96, dtype)
        self.cost_agg = Hourglass(GROUPS, dtype)
        self.classifier = Conv3d(GROUPS, 1, 3, padding=1, bias=False,
                                 dtype=dtype)
        self.geo_block = GeometryVolume(corr_levels, corr_radius)
        self.corr_block = CorrBlock1D(corr_levels, corr_radius, scaled=False)
        self.update_graphs = graphs.GraphCache("nmrf::igev.graph_capture")

    def train(self, mode=True):
        if mode:
            raise NotImplementedError(
                "IGEV-Stereo's training (the starting disparity's smooth-L1 "
                "loss and the sequence loss) is not ported; the port serves "
                "it in eval mode")
        return super().train(False)

    def features(self, img1, img2):
        """(normalised images [2B, H, W, 3], the left image's features at
        1/4 .. 1/32, ``stem_2``'s left map, both images' matching
        features)."""
        B = img1.shape[0]
        x = 2 * (torch.cat([img1, img2]) / 255.0) - 1.0
        feats = self.feature(x)
        stem_2 = self.stem_2(x)
        feats[0] = torch.cat([feats[0], self.stem_4(stem_2)], dim=-1)
        match = self.desc(self.conv(feats[0]))
        return x, [f[:B] for f in feats], stem_2[:B], match.split(B)

    def volume(self, match1, match2, left):
        """(the GEV [B, D, h, w, 8], the starting disparity [B, h, w])."""
        d = self.max_disp // 4
        gwc = correlation_volume(match1, match2, d, GROUPS)  # [B,h,w,G,D]
        gwc = self.corr_stem(gwc.permute(0, 4, 1, 2, 3).contiguous())
        gwc = self.corr_feature_att(gwc, left[0])
        geo = self.cost_agg(gwc, left)
        prob = torch.softmax(self.classifier(geo)[..., 0].float(), dim=1)
        values = torch.arange(d, device=prob.device, dtype=prob.dtype)
        return geo, (prob * values.view(1, d, 1, 1)).sum(1)

    def lookup(self, geo_pyr, corr_pyr, disp, consts):
        """The combined lookup of ``disp`` [B, h, w] -> [B, h, w, levels x
        (8 + 1) x (2 radius + 1)]: per level the GEV's taps channel by
        channel, then the all-pairs volume's (upstream's order).
        ``consts``: :meth:`lookup_consts`."""
        columns, geo_grid, corr_grid = consts
        B, h, w = disp.shape
        L = self.geo_block.num_levels
        geo = self.geo_block.lookup(geo_pyr, disp, geo_grid)
        corr = self.corr_block.lookup(corr_pyr, columns - disp, corr_grid)
        return torch.cat([geo.reshape(B, h, w, L, -1),
                          corr.view(B, h, w, L, -1)], dim=-1).reshape(
            B, h, w, -1)

    def lookup_consts(self, w, device):
        """The lookup's constants for a 1/4 row of ``w`` columns: the
        column indices and both pyramids' grids."""
        return (torch.arange(w, device=device, dtype=torch.float32),
                self.geo_block.grid(self.max_disp // 4, device),
                self.corr_block.grid(w, device))

    def _loop_graphs(self, geo_pyr, corr_pyr, net, inp, disp):
        """A ``with`` context that gives the loop's ``graphs.UpdateGraphs``
        at this shape (``graphs.hold_loop``), or None where the loop runs
        eagerly.  The graphs hold both pyramids and the context biases; the
        lookup's constants are made once, at capture."""
        held = [geo_pyr, corr_pyr, *(t for level in inp for t in level)]

        def build():
            consts = self.lookup_consts(corr_pyr.shape[2], corr_pyr.device)
            return graphs.UpdateGraphs(
                held, lambda h, d: self.lookup(h[0], h[1], d, consts), disp,
                lambda h, n, corr, d: self.update_block.forward(
                    n, regroup(h[2:]), corr, d),
                net, disp.unsqueeze(-1), consts=consts)

        return graphs.hold_loop(self.update_graphs, geo_pyr,
                                [*held[:2], *net, *held[2:]],
                                self.update_block, build)

    def upsample_disp(self, disp, mask_feat, stem_2x):
        """The 1/4 disparity to full resolution: 9 weights a pixel from
        ``mask_feat_4`` and ``stem_2``'s map, a softmax over them, and
        ``context_upsample`` of 4 x disp."""
        weights = self.spx_gru(self.spx_2_gru(mask_feat, stem_2x))
        return context_upsample(4 * disp, torch.softmax(weights.float(), -1))

    def forward(self, img1, img2):
        with record_function("nmrf::igev.features"):
            x, left, stem_2x, (match1, match2) = self.features(img1, img2)
        with record_function("nmrf::igev.volume"):
            geo, init_disp = self.volume(match1, match2, left)
        with record_function("nmrf::igev.context"):
            net, inp = hidden_and_context(self.cnet(x[:img1.shape[0]]),
                                          self.context_zqr_convs)
        with record_function("nmrf::igev.corr"):
            geo_pyr = self.geo_block(geo)
            corr_pyr = self.corr_block(match1, match2)
        with record_function("nmrf::igev.update"):
            disp = init_disp
            with self._loop_graphs(geo_pyr, corr_pyr, net, inp,
                                   disp) as loop:
                if loop is None:
                    consts = self.lookup_consts(match1.shape[2],
                                                match1.device)

                    def lookup(d):
                        return self.lookup(geo_pyr, corr_pyr, d, consts)
                else:
                    loop.load([geo_pyr, corr_pyr,
                               *(t for level in inp for t in level)])
                    lookup = loop.lookup
                self.iterations = 0
                for _ in range(self.valid_iters):
                    with record_function("nmrf::igev.lookup"):
                        corr = lookup(disp)
                    net, mask_feat, delta = self.update_block(
                        net, inp, corr, disp.unsqueeze(-1), replay=loop)
                    disp = disp + delta[..., 0]
                    self.iterations += 1
        with record_function("nmrf::igev.upsample"):
            return {"disp": self.upsample_disp(disp, mask_feat, stem_2x),
                    "disp_lowres": disp, "init_disp": init_disp}


def build_igev_stereo(cfg, dtype):
    """The model of a config tree's ``RAFT`` node (the keys both models
    read) and ``IGEV.MAX_DISP``, its weights from ``cfg.SEED`` (on the
    CPU; ``raft_stereo.init_weights``)."""
    r = cfg.RAFT
    model = IGEVStereo(hidden_dims=r.HIDDEN_DIMS, n_downsample=r.N_DOWNSAMPLE,
                       corr_levels=r.CORR_LEVELS, corr_radius=r.CORR_RADIUS,
                       valid_iters=r.VALID_ITERS, max_disp=cfg.IGEV.MAX_DISP,
                       dtype=dtype)
    return init_weights(model, cfg.SEED)
