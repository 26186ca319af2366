"""The plain float32 IGEV-Stereo reference of the benchmark (Xu, Wang, Ding,
Yang, "Iterative Geometry Encoding Volume for Stereo Matching", CVPR 2023,
arXiv:2303.06615; github.com/gangweiX/IGEV), and its seeded weights.

It follows upstream's ``core/igev_stereo.py`` (``IGEVStereo``,
``hourglass``), ``core/submodule.py`` (``BasicConv``, ``BasicConv_IN``,
``Conv2x``, ``Conv2x_IN``, ``FeatureAtt``, ``build_gwc_volume``,
``disparity_regression``, ``context_upsample``), ``core/extractor.py``
(``Feature``; ``MultiBasicEncoder``, RAFT-Stereo's), ``core/update.py``
(``BasicMotionEncoder``, ``BasicMultiUpdateBlock``, ``DispHead``; the GRU
RAFT-Stereo's) and ``core/geometry.py`` (``Combined_Geo_Encoding_Volume``
with ``bilinear_sampler``, i.e. ``grid_sample``) as they run at the
defaults of ``train_stereo.py``/``evaluate_stereo.py`` (``hidden_dims``
128 x 3, 3 GRU levels, ``n_downsample`` 2, 2 levels of radius 4,
``max_disp`` 192, no slow-fast GRU) in ``test_mode``, NCHW inside as
upstream.  Module names are upstream's ``state_dict`` keys.  The parts
RAFT-Stereo shares (the context encoder, the GRU, the flow head, the
pooling and the sampler) are the RAFT-Stereo reference's
(``raft_stereo.py`` here).  It imports nothing of the measured package.

Departures from the published code:

- MobileNetV2 is written out in timm's ``mobilenetv2_100`` layout (the
  stem, ``blocks[0:6]``, timm's names) in place of ``timm.create_model``,
  and its weights are random like the rest (upstream loads ImageNet's);
- the caller pads: the benchmark pads right and bottom by edge
  replication to 32 (the measured package's ``InputPadder``), where
  upstream's ``InputPadder`` replicates on both sides; both sides of the
  comparison take the same padded input;
- float32 throughout (TF32 off in the caller, ``harness.strict_f32``);
  upstream's ``--mixed_precision`` autocasts the convolutions to float16;
- inputs [B, H, W, 3] and the returned maps channel-last, the layout of
  the measured package;
- the forward returns, besides the disparity, what the benchmark's check
  compares: both images' matching features (``desc``), the hourglass's
  output volume, the starting disparity, the 1/4 hidden state and the
  1/4 disparity after the iterations asked for.

No stage needs to be computed in blocks at 384 x 1248 (the largest
tensors, the group-wise volume and the hourglass's first level, hold
under 100 MB in float32).

``init_weights`` makes the weights both sides load (:func:`_scales`) and
sets the batch norms' running statistics from one calibration batch.
``set_fp8`` turns the model into the control: every convolution's input
and weight rounded to float8 e4m3.  ``set_fault`` plants one of the
faults the check must catch: ``gev_tap`` (the GEV's lookup read one tap
to the right), ``att_skip`` (``corr_feature_att``'s gate skipped: the
volume passed on ungated) and ``corr_scaled`` (the all-pairs volume over
sqrt(C), RAFT-Stereo's ``reg``)."""

import torch
import torch.nn.functional as F
from torch import nn

from .raft_stereo import (Conv2d, ConvGRU, FlowHead, MultiBasicEncoder,
                          _last, _Precision, bilinear_sampler, interp, pool2x)

FAULTS = ("gev_tap", "att_skip", "corr_scaled")


class Conv3d(nn.Conv3d, _Precision):
    def forward(self, x):
        x, w = self.lowp(x, self.weight)
        return self._conv_forward(x, w, self.bias)


class ConvTranspose2d(nn.ConvTranspose2d, _Precision):
    def forward(self, x):
        x, w = self.lowp(x, self.weight)
        return F.conv_transpose2d(x, w, self.bias, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class ConvTranspose3d(nn.ConvTranspose3d, _Precision):
    def forward(self, x):
        x, w = self.lowp(x, self.weight)
        return F.conv_transpose3d(x, w, self.bias, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


# --------------------------------------------------------------------------- #
# core/submodule.py
# --------------------------------------------------------------------------- #

def _conv(deconv, is_3d):
    return {(False, False): Conv2d, (True, False): ConvTranspose2d,
            (False, True): Conv3d,
            (True, True): ConvTranspose3d}[deconv, is_3d]


class BasicConv(nn.Module):
    def __init__(self, in_channels, out_channels, deconv=False, is_3d=False,
                 bn=True, relu=True, **kwargs):
        super().__init__()
        self.relu = relu
        self.use_bn = bn
        self.conv = _conv(deconv, is_3d)(in_channels, out_channels,
                                         bias=False, **kwargs)
        self.bn = (nn.BatchNorm3d if is_3d else nn.BatchNorm2d)(out_channels)

    def forward(self, x):
        x = self.conv(x)
        if self.use_bn:
            x = self.bn(x)
        if self.relu:
            x = F.leaky_relu(x)
        return x


class BasicConv_IN(nn.Module):
    def __init__(self, in_channels, out_channels, deconv=False, is_3d=False,
                 IN=True, relu=True, **kwargs):
        super().__init__()
        self.relu = relu
        self.use_in = IN
        self.conv = _conv(deconv, is_3d)(in_channels, out_channels,
                                         bias=False, **kwargs)
        self.IN = (nn.InstanceNorm3d if is_3d
                   else nn.InstanceNorm2d)(out_channels)

    def forward(self, x):
        x = self.conv(x)
        if self.use_in:
            x = self.IN(x)
        if self.relu:
            x = F.leaky_relu(x)
        return x


class Conv2x(nn.Module):
    """``Conv2x`` (``Conv2x_IN`` with ``block=BasicConv_IN``) as IGEV builds
    it: 2-D, ``concat``, ``keep_concat``."""

    def __init__(self, in_channels, out_channels, deconv=False,
                 block=BasicConv):
        super().__init__()
        kernel = 4 if deconv else 3
        self.conv1 = block(in_channels, out_channels, deconv, False,
                           kernel_size=kernel, stride=2, padding=1)
        self.conv2 = block(out_channels * 2, out_channels * 2, False, False,
                           kernel_size=3, stride=1, padding=1)

    def forward(self, x, rem):
        x = self.conv1(x)
        if x.shape != rem.shape:
            x = F.interpolate(x, size=(rem.shape[-2], rem.shape[-1]),
                              mode="nearest")
        return self.conv2(torch.cat((x, rem), 1))


class FeatureAtt(nn.Module):
    skip = False

    def __init__(self, cv_chan, feat_chan):
        super().__init__()
        self.feat_att = nn.Sequential(
            BasicConv(feat_chan, feat_chan // 2, kernel_size=1, stride=1,
                      padding=0),
            Conv2d(feat_chan // 2, cv_chan, 1))

    def forward(self, cv, feat):
        if self.skip:
            return cv
        feat_att = self.feat_att(feat).unsqueeze(2)
        return torch.sigmoid(feat_att) * cv


def groupwise_correlation(fea1, fea2, num_groups):
    B, C, H, W = fea1.shape
    channels_per_group = C // num_groups
    return (fea1 * fea2).view([B, num_groups, channels_per_group, H,
                               W]).mean(dim=2)


def build_gwc_volume(refimg_fea, targetimg_fea, maxdisp, num_groups):
    B, C, H, W = refimg_fea.shape
    volume = refimg_fea.new_zeros([B, num_groups, maxdisp, H, W])
    for i in range(maxdisp):
        if i > 0:
            volume[:, :, i, :, i:] = groupwise_correlation(
                refimg_fea[:, :, :, i:], targetimg_fea[:, :, :, :-i],
                num_groups)
        else:
            volume[:, :, i, :, :] = groupwise_correlation(
                refimg_fea, targetimg_fea, num_groups)
    return volume.contiguous()


def disparity_regression(x, maxdisp):
    disp_values = torch.arange(0, maxdisp, dtype=x.dtype, device=x.device)
    return torch.sum(x * disp_values.view(1, maxdisp, 1, 1), 1, keepdim=True)


def context_upsample(disp_low, up_weights):
    b, c, h, w = disp_low.shape
    disp_unfold = F.unfold(disp_low.reshape(b, c, h, w), 3, 1, 1).reshape(
        b, -1, h, w)
    disp_unfold = F.interpolate(disp_unfold, (h * 4, w * 4),
                                mode="nearest").reshape(b, 9, h * 4, w * 4)
    return (disp_unfold * up_weights).sum(1)


# --------------------------------------------------------------------------- #
# core/extractor.py: Feature, with timm's mobilenetv2_100 written out
# --------------------------------------------------------------------------- #

class DepthwiseSeparableConv(nn.Module):
    def __init__(self, in_chs, out_chs):
        super().__init__()
        self.conv_dw = Conv2d(in_chs, in_chs, 3, padding=1, groups=in_chs,
                              bias=False)
        self.bn1 = nn.BatchNorm2d(in_chs)
        self.conv_pw = Conv2d(in_chs, out_chs, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_chs)

    def forward(self, x):
        x = F.relu6(self.bn1(self.conv_dw(x)))
        return self.bn2(self.conv_pw(x))


class InvertedResidual(nn.Module):
    def __init__(self, in_chs, out_chs, stride, exp_ratio):
        super().__init__()
        mid = in_chs * exp_ratio
        self.has_skip = stride == 1 and in_chs == out_chs
        self.conv_pw = Conv2d(in_chs, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid)
        self.conv_dw = Conv2d(mid, mid, 3, stride=stride, padding=1,
                              groups=mid, bias=False)
        self.bn2 = nn.BatchNorm2d(mid)
        self.conv_pwl = Conv2d(mid, out_chs, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_chs)

    def forward(self, x):
        shortcut = x
        x = F.relu6(self.bn1(self.conv_pw(x)))
        x = F.relu6(self.bn2(self.conv_dw(x)))
        x = self.bn3(self.conv_pwl(x))
        return x + shortcut if self.has_skip else x


def mobilenetv2_blocks():
    """timm's ``mobilenetv2_100.blocks[0:6]`` (arch ``ds_r1_k3_s1_c16``,
    ``ir_r2_k3_s2_e6_c24``, ``ir_r3_k3_s2_e6_c32``, ``ir_r4_k3_s2_e6_c64``,
    ``ir_r3_k3_s1_e6_c96``, ``ir_r3_k3_s2_e6_c160``) after a 32-channel
    stem."""
    blocks = [nn.Sequential(DepthwiseSeparableConv(32, 16))]
    in_chs = 16
    for n, stride, chs in ((2, 2, 24), (3, 2, 32), (4, 2, 64), (3, 1, 96),
                           (3, 2, 160)):
        blocks.append(nn.Sequential(*(
            InvertedResidual(in_chs if j == 0 else chs, chs,
                             stride if j == 0 else 1, 6) for j in range(n))))
        in_chs = chs
    return blocks


class Feature(nn.Module):
    def __init__(self):
        super().__init__()
        layers = [1, 2, 3, 5, 6]
        chans = [16, 24, 32, 96, 160]
        blocks = mobilenetv2_blocks()
        self.conv_stem = Conv2d(3, 32, 3, stride=2, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(32)
        self.block0 = nn.Sequential(*blocks[0:layers[0]])
        self.block1 = nn.Sequential(*blocks[layers[0]:layers[1]])
        self.block2 = nn.Sequential(*blocks[layers[1]:layers[2]])
        self.block3 = nn.Sequential(*blocks[layers[2]:layers[3]])
        self.block4 = nn.Sequential(*blocks[layers[3]:layers[4]])
        self.deconv32_16 = Conv2x(chans[4], chans[3], True, BasicConv_IN)
        self.deconv16_8 = Conv2x(chans[3] * 2, chans[2], True, BasicConv_IN)
        self.deconv8_4 = Conv2x(chans[2] * 2, chans[1], True, BasicConv_IN)
        self.conv4 = BasicConv_IN(chans[1] * 2, chans[1] * 2, kernel_size=3,
                                  stride=1, padding=1)

    def forward(self, x):
        x = F.relu6(self.bn1(self.conv_stem(x)))
        x2 = self.block0(x)
        x4 = self.block1(x2)
        x8 = self.block2(x4)
        x16 = self.block3(x8)
        x32 = self.block4(x16)
        x16 = self.deconv32_16(x32, x16)
        x8 = self.deconv16_8(x16, x8)
        x4 = self.deconv8_4(x8, x4)
        x4 = self.conv4(x4)
        return [x4, x8, x16, x32]


# --------------------------------------------------------------------------- #
# core/update.py
# --------------------------------------------------------------------------- #

class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_levels, corr_radius):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) * (8 + 1)
        self.convc1 = Conv2d(cor_planes, 64, 1, padding=0)
        self.convc2 = Conv2d(64, 64, 3, padding=1)
        self.convd1 = Conv2d(1, 64, 7, padding=3)
        self.convd2 = Conv2d(64, 64, 3, padding=1)
        self.conv = Conv2d(64 + 64, 128 - 1, 3, padding=1)

    def forward(self, disp, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        disp_ = F.relu(self.convd2(F.relu(self.convd1(disp))))
        out = F.relu(self.conv(torch.cat([cor, disp_], dim=1)))
        return torch.cat([out, disp], dim=1)


class BasicMultiUpdateBlock(nn.Module):
    """``gru04`` at 1/4, ``gru08`` at 1/8, ``gru16`` at 1/16, coarse to
    fine, then ``disp_head`` and ``mask_feat_4``."""

    def __init__(self, hidden_dims, corr_levels, corr_radius):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru04 = ConvGRU(hidden_dims[2], 128 + hidden_dims[1])
        self.gru08 = ConvGRU(hidden_dims[1], hidden_dims[0] + hidden_dims[2])
        self.gru16 = ConvGRU(hidden_dims[0], hidden_dims[1])
        self.disp_head = FlowHead(hidden_dims[2], hidden_dim=256,
                                  output_dim=1)
        self.mask_feat_4 = nn.Sequential(
            Conv2d(hidden_dims[2], 32, 3, padding=1), nn.ReLU())

    def forward(self, net, inp, corr, disp):
        net = list(net)
        net[2] = self.gru16(net[2], *inp[2], pool2x(net[1]))
        net[1] = self.gru08(net[1], *inp[1], pool2x(net[0]),
                            interp(net[2], net[1]))
        motion_features = self.encoder(disp, corr)
        net[0] = self.gru04(net[0], *inp[0], motion_features,
                            interp(net[1], net[0]))
        delta_disp = self.disp_head(net[0])
        mask_feat_4 = self.mask_feat_4(net[0])
        return net, mask_feat_4, delta_disp


# --------------------------------------------------------------------------- #
# core/geometry.py
# --------------------------------------------------------------------------- #

class Combined_Geo_Encoding_Volume:
    def __init__(self, init_fmap1, init_fmap2, geo_volume, num_levels=2,
                 radius=4, fault=None):
        self.num_levels = num_levels
        self.radius = radius
        self.fault = fault
        self.geo_volume_pyramid = []
        self.init_corr_pyramid = []
        init_corr = self.corr(init_fmap1, init_fmap2)
        if fault == "corr_scaled":
            init_corr = init_corr / init_fmap1.shape[1] ** 0.5
        b, h, w, _, w2 = init_corr.shape
        b, c, d, h, w = geo_volume.shape
        geo_volume = geo_volume.permute(0, 3, 4, 1, 2).reshape(b * h * w, c,
                                                               1, d)
        init_corr = init_corr.reshape(b * h * w, 1, 1, w2)
        self.geo_volume_pyramid.append(geo_volume)
        self.init_corr_pyramid.append(init_corr)
        for _ in range(self.num_levels - 1):
            geo_volume = F.avg_pool2d(geo_volume, [1, 2], stride=[1, 2])
            self.geo_volume_pyramid.append(geo_volume)
        for _ in range(self.num_levels - 1):
            init_corr = F.avg_pool2d(init_corr, [1, 2], stride=[1, 2])
            self.init_corr_pyramid.append(init_corr)

    def __call__(self, disp, coords):
        r = self.radius
        b, _, h, w = disp.shape
        out_pyramid = []
        for i in range(self.num_levels):
            geo_volume = self.geo_volume_pyramid[i]
            dx = torch.linspace(-r, r, 2 * r + 1)
            dx = dx.view(1, 1, 2 * r + 1, 1).to(disp.device)
            shift = 1.0 if self.fault == "gev_tap" else 0.0
            x0 = dx + shift + disp.reshape(b * h * w, 1, 1, 1) / 2 ** i
            y0 = torch.zeros_like(x0)
            disp_lvl = torch.cat([x0, y0], dim=-1)
            geo_volume = bilinear_sampler(geo_volume, disp_lvl)
            geo_volume = geo_volume.view(b, h, w, -1)

            init_corr = self.init_corr_pyramid[i]
            init_x0 = coords.reshape(b * h * w, 1, 1, 1) / 2 ** i \
                - disp.reshape(b * h * w, 1, 1, 1) / 2 ** i + dx
            init_coords_lvl = torch.cat([init_x0, y0], dim=-1)
            init_corr = bilinear_sampler(init_corr, init_coords_lvl)
            init_corr = init_corr.view(b, h, w, -1)

            out_pyramid.append(geo_volume)
            out_pyramid.append(init_corr)
        out = torch.cat(out_pyramid, dim=-1)
        return out.permute(0, 3, 1, 2).contiguous().float()

    @staticmethod
    def corr(fmap1, fmap2):
        B, D, H, W1 = fmap1.shape
        _, _, _, W2 = fmap2.shape
        corr = torch.einsum("aijk,aijh->ajkh", fmap1, fmap2)
        return corr.reshape(B, H, W1, 1, W2).contiguous()


# --------------------------------------------------------------------------- #
# core/igev_stereo.py
# --------------------------------------------------------------------------- #

class hourglass(nn.Module):
    def __init__(self, in_channels):
        super().__init__()
        c = in_channels

        def conv3(i, o, **kwargs):
            return BasicConv(i, o, is_3d=True, **kwargs)

        self.conv1 = nn.Sequential(
            conv3(c, c * 2, kernel_size=3, padding=1, stride=2),
            conv3(c * 2, c * 2, kernel_size=3, padding=1, stride=1))
        self.conv2 = nn.Sequential(
            conv3(c * 2, c * 4, kernel_size=3, padding=1, stride=2),
            conv3(c * 4, c * 4, kernel_size=3, padding=1, stride=1))
        self.conv3 = nn.Sequential(
            conv3(c * 4, c * 6, kernel_size=3, padding=1, stride=2),
            conv3(c * 6, c * 6, kernel_size=3, padding=1, stride=1))
        self.conv3_up = conv3(c * 6, c * 4, deconv=True, kernel_size=(4, 4, 4),
                              padding=(1, 1, 1), stride=(2, 2, 2))
        self.conv2_up = conv3(c * 4, c * 2, deconv=True, kernel_size=(4, 4, 4),
                              padding=(1, 1, 1), stride=(2, 2, 2))
        self.conv1_up = conv3(c * 2, 8, deconv=True, bn=False, relu=False,
                              kernel_size=(4, 4, 4), padding=(1, 1, 1),
                              stride=(2, 2, 2))
        self.agg_0 = nn.Sequential(
            conv3(c * 8, c * 4, kernel_size=1, padding=0, stride=1),
            conv3(c * 4, c * 4, kernel_size=3, padding=1, stride=1),
            conv3(c * 4, c * 4, kernel_size=3, padding=1, stride=1))
        self.agg_1 = nn.Sequential(
            conv3(c * 4, c * 2, kernel_size=1, padding=0, stride=1),
            conv3(c * 2, c * 2, kernel_size=3, padding=1, stride=1),
            conv3(c * 2, c * 2, kernel_size=3, padding=1, stride=1))
        self.feature_att_8 = FeatureAtt(c * 2, 64)
        self.feature_att_16 = FeatureAtt(c * 4, 192)
        self.feature_att_32 = FeatureAtt(c * 6, 160)
        self.feature_att_up_16 = FeatureAtt(c * 4, 192)
        self.feature_att_up_8 = FeatureAtt(c * 2, 64)

    def forward(self, x, features):
        conv1 = self.conv1(x)
        conv1 = self.feature_att_8(conv1, features[1])
        conv2 = self.conv2(conv1)
        conv2 = self.feature_att_16(conv2, features[2])
        conv3 = self.conv3(conv2)
        conv3 = self.feature_att_32(conv3, features[3])
        conv3_up = self.conv3_up(conv3)
        conv2 = torch.cat((conv3_up, conv2), dim=1)
        conv2 = self.agg_0(conv2)
        conv2 = self.feature_att_up_16(conv2, features[2])
        conv2_up = self.conv2_up(conv2)
        conv1 = torch.cat((conv2_up, conv1), dim=1)
        conv1 = self.agg_1(conv1)
        conv1 = self.feature_att_up_8(conv1, features[1])
        return self.conv1_up(conv1)


def _stem(i, o):
    return nn.Sequential(BasicConv_IN(i, o, kernel_size=3, stride=2,
                                      padding=1),
                         Conv2d(o, o, 3, 1, 1, bias=False),
                         nn.InstanceNorm2d(o), nn.ReLU())


class IGEVStereo(nn.Module):
    """``spec``: a configuration's keys (``RAFT.HIDDEN_DIMS``, ...,
    ``IGEV.MAX_DISP``).  forward(img1, img2) on [B, H, W, 3] (0..255, H
    and W multiples of 32) returns ``disp`` [B, H, W], and for the check
    ``match`` [2B, h, w, 96] (both images' ``desc`` features), ``geo``
    [B, D, h, w, 8] (the hourglass's output), ``init_disp`` [B, h, w],
    ``hidden`` {t: the 1/4 hidden state [B, h, w, C] after iteration t}
    and ``disp_lowres`` {t: the 1/4 disparity [B, h, w] after iteration
    t}, for the iterations in ``keep_hidden`` and ``keep_disp`` (the
    state after the last iteration for a later one)."""

    def __init__(self, spec):
        super().__init__()
        hidden = list(spec["RAFT.HIDDEN_DIMS"])
        self.n_downsample = spec["RAFT.N_DOWNSAMPLE"]
        self.corr_levels = spec["RAFT.CORR_LEVELS"]
        self.corr_radius = spec["RAFT.CORR_RADIUS"]
        self.valid_iters = spec["RAFT.VALID_ITERS"]
        self.max_disp = spec["IGEV.MAX_DISP"]
        self.fault = None
        self.cnet = MultiBasicEncoder([hidden, hidden], "batch",
                                      self.n_downsample)
        self.update_block = BasicMultiUpdateBlock(hidden, self.corr_levels,
                                                  self.corr_radius)
        self.context_zqr_convs = nn.ModuleList(
            Conv2d(hidden[i], hidden[i] * 3, 3, padding=1) for i in range(3))
        self.feature = Feature()
        self.stem_2 = _stem(3, 32)
        self.stem_4 = _stem(32, 48)
        self.spx = nn.Sequential(ConvTranspose2d(2 * 32, 9, kernel_size=4,
                                                 stride=2, padding=1))
        self.spx_2 = Conv2x(24, 32, True, BasicConv_IN)
        self.spx_4 = nn.Sequential(
            BasicConv_IN(96, 24, kernel_size=3, stride=1, padding=1),
            Conv2d(24, 24, 3, 1, 1, bias=False), nn.InstanceNorm2d(24),
            nn.ReLU())
        self.spx_2_gru = Conv2x(32, 32, True)
        self.spx_gru = nn.Sequential(ConvTranspose2d(2 * 32, 9, kernel_size=4,
                                                     stride=2, padding=1))
        self.conv = BasicConv_IN(96, 96, kernel_size=3, padding=1, stride=1)
        self.desc = Conv2d(96, 96, kernel_size=1, padding=0, stride=1)
        self.corr_stem = BasicConv(8, 8, is_3d=True, kernel_size=3, stride=1,
                                   padding=1)
        self.corr_feature_att = FeatureAtt(8, 96)
        self.cost_agg = hourglass(8)
        self.classifier = Conv3d(8, 1, 3, 1, 1, bias=False)

    def set_fault(self, name):
        if name is not None and name not in FAULTS:
            raise ValueError(f"no fault {name!r}")
        self.fault = name
        self.corr_feature_att.skip = name == "att_skip"
        return self

    def upsample_disp(self, disp, mask_feat_4, stem_2x):
        xspx = self.spx_2_gru(mask_feat_4, stem_2x)
        spx_pred = F.softmax(self.spx_gru(xspx), 1)
        return context_upsample(disp * 4., spx_pred).unsqueeze(1)

    def volume(self, features_left, match_left, match_right):
        """The GEV stage: the group-wise volume through the starting
        disparity -> (geo_encoding_volume, init_disp)."""
        D = self.max_disp // 4
        gwc_volume = build_gwc_volume(match_left, match_right, D, 8)
        gwc_volume = self.corr_stem(gwc_volume)
        gwc_volume = self.corr_feature_att(gwc_volume, features_left[0])
        geo_encoding_volume = self.cost_agg(gwc_volume, features_left)
        prob = F.softmax(self.classifier(geo_encoding_volume).squeeze(1),
                         dim=1)
        return geo_encoding_volume, disparity_regression(prob, D)

    def forward(self, img1, img2, keep_hidden=(), keep_disp=()):
        image1 = (2 * (img1.permute(0, 3, 1, 2) / 255.0) - 1.0).contiguous()
        image2 = (2 * (img2.permute(0, 3, 1, 2) / 255.0) - 1.0).contiguous()
        features_left = self.feature(image1)
        features_right = self.feature(image2)
        stem_2x = self.stem_2(image1)
        stem_4x = self.stem_4(stem_2x)
        stem_2y = self.stem_2(image2)
        stem_4y = self.stem_4(stem_2y)
        features_left[0] = torch.cat((features_left[0], stem_4x), 1)
        features_right[0] = torch.cat((features_right[0], stem_4y), 1)
        match_left = self.desc(self.conv(features_left[0]))
        match_right = self.desc(self.conv(features_right[0]))
        geo_encoding_volume, init_disp = self.volume(features_left,
                                                     match_left, match_right)

        cnet_list = self.cnet(image1)
        net_list = [torch.tanh(x[0]) for x in cnet_list]
        inp_list = [torch.relu(x[1]) for x in cnet_list]
        inp_list = [list(conv(i).split(conv.out_channels // 3, dim=1))
                    for i, conv in zip(inp_list, self.context_zqr_convs)]

        geo_fn = Combined_Geo_Encoding_Volume(
            match_left.float(), match_right.float(),
            geo_encoding_volume.float(), radius=self.corr_radius,
            num_levels=self.corr_levels, fault=self.fault)
        b, c, h, w = match_left.shape
        coords = torch.arange(w).float().to(match_left.device).reshape(
            1, 1, w, 1).repeat(b, h, 1, 1)
        disp = init_disp
        out = {"match": _last(torch.cat([match_left, match_right])),
               "geo": geo_encoding_volume.permute(0, 2, 3, 4, 1),
               "init_disp": init_disp[:, 0], "hidden": {}, "disp_lowres": {}}
        for itr in range(self.valid_iters):
            disp = disp.detach()
            geo_feat = geo_fn(disp, coords)
            net_list, mask_feat_4, delta_disp = self.update_block(
                net_list, inp_list, geo_feat, disp)
            disp = disp + delta_disp
            if itr + 1 in keep_hidden:
                out["hidden"][itr + 1] = _last(net_list[0])
            if itr + 1 in keep_disp:
                out["disp_lowres"][itr + 1] = disp[:, 0]
        for t in keep_hidden:
            out["hidden"].setdefault(t, _last(net_list[0]))
        for t in keep_disp:
            out["disp_lowres"].setdefault(t, disp[:, 0])
        out["disp"] = self.upsample_disp(disp, mask_feat_4, stem_2x)[:, 0]
        return out


def build(spec, device):
    """The reference model of a configuration, on ``device``, float32, in
    eval mode (weights uninitialised)."""
    return IGEVStereo(spec).to(device).eval()


# the seeded draw's scales (``assumed`` in
# ``benchmark/configs/igev_stereo.json``): gains over the default scale of
# the weights named
GAINS = {
    "classifier.weight": 4.0,   # a starting disparity varying by pixels
    "update_block.disp_head.conv2.weight": 0.5,  # a fraction of a pixel a step
    # the motion encoder driven by the lookup's taps more than by the
    # disparity's value, so that the iterations read both volumes
    "update_block.encoder.convc1.weight": 10.0,
    "update_block.encoder.convc2.weight": 3.0,
    "update_block.encoder.conv.weight": 3.0,
    "update_block.encoder.convd1.weight": 0.1,
}
CALIBRATION = (2, 96, 256)  # the pairs and size of the norms' calibration
SHIFT = 16  # the calibration pair's disparity, pixels
# the batch norms of the trunk, the volume stage and spx_2_gru: bias
# NORM_BIAS, the LeakyReLU's and ReLU6's inputs mostly positive
NORM_BIAS = 1.5
SHIFTED = ("feature.", "corr_stem.", "corr_feature_att.", "cost_agg.",
           "spx_2_gru.")
# the modules whose every convolution is Kaiming normal (fan out)
ENCODERS = ("cnet.", "feature.", "stem_2.", "stem_4.", "spx_4.", "spx_2.")


def _scales(model):
    """{name: (std, mean)} of each parameter's seeded draw: norm weights 1
    and biases 0, but ``NORM_BIAS`` in the batch norms of ``SHIFTED``
    (with random weights a stack of convolutions, batch norms and
    LeakyReLUs about zero is chaotic: at 128 x 384 a 1% change of the
    hourglass's input read 7.6% at its output with biases 0, 1.5% with
    1.5, and bf16 against float32 30% and 1.3%; trained weights are not
    chaotic); every other bias 0; a convolution whose output a norm
    takes Kaiming normal (fan out: upstream's ``weight_init``), and so is
    every convolution of the encoders (``ENCODERS``: RAFT-Stereo's
    initialiser of ``cnet``, timm's of MobileNetV2); the others
    (``desc``, ``FeatureAtt``'s gates, ``classifier``, ``context_zqr_convs``,
    ``update_block``, ``spx_gru`` and ``spx``) at PyTorch's default weight
    scale (the variance of its uniform draw, std 1 / sqrt(3 fan_in)); a
    weight in ``GAINS`` at that many times its scale: ``classifier`` 4 (the
    starting disparity's softmax peaked enough that it varies pixel by
    pixel), ``disp_head``'s last convolution 0.5 (a step of a fraction of
    a pixel an iteration: the disparity stays positive and most taps inside
    the row over 32 iterations), the motion encoder's ``convc1``,
    ``convc2`` and ``conv`` 10, 3 and 3 and its ``convd1`` 0.1 (its
    features then follow the lookup's taps, not the disparity's value: at
    128 x 384 the GEV read one tap off moved the hidden state 18% against
    bf16's 4%, where with the default scales it moved it 0.3% against
    2.4%)."""
    normed = {f"{prefix}.conv.weight" for prefix, m in model.named_modules()
              if isinstance(m, (BasicConv, BasicConv_IN))}
    out = {}
    for prefix, m in model.named_modules():
        for leaf, p in m.named_parameters(recurse=False):
            name = f"{prefix}.{leaf}"
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                bias = NORM_BIAS if name.startswith(SHIFTED) else 0.0
                out[name] = (0.0, 1.0 if leaf == "weight" else bias)
            elif leaf == "bias":
                out[name] = (0.0, 0.0)
            elif name in normed or name.startswith(ENCODERS):
                out[name] = (GAINS.get(name, 1.0) * (
                    2.0 / (p.shape[0] * p[0, 0].numel())) ** 0.5, 0.0)
            else:
                # a transposed convolution's weight is [in, out, k...]
                transposed = isinstance(m, (nn.ConvTranspose2d,
                                            nn.ConvTranspose3d))
                fan_in = p.shape[0 if transposed else 1] * p[0, 0].numel()
                gain = GAINS.get(name, 1.0)
                out[name] = (gain * (1.0 / (3.0 * fan_in)) ** 0.5, 0.0)
    return out


@torch.no_grad()
def init_weights(model, seed):
    """Seeded weights, made on the model's device from one generator in
    one draw and scaled leaf by leaf (:func:`_scales`); then the batch
    norms' running statistics: the forward run once with every batch norm
    in training mode (each norm's running mean and variance those of its
    batch) and one iteration, on ``CALIBRATION`` pairs of uniform noise
    from the same generator, the second image the first moved ``SHIFT``
    pixels to the left (a disparity of ``SHIFT``), so that each norm's
    output has about unit variance on such frames."""
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
    B, H, W = CALIBRATION
    left = torch.rand(B, H, W + SHIFT, 3, generator=gen, device=device) \
        * 255.0
    img1, img2 = left[:, :, :W], left[:, :, SHIFT:]
    norms = [m for m in model.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None  # a cumulative average: one batch's statistics
        m.train()
    iters, model.valid_iters = model.valid_iters, 1
    try:
        model(img1.contiguous(), img2.contiguous())
    finally:
        model.valid_iters = iters
        for m in norms:
            m.eval()
            m.momentum = 0.1
    return model


def set_fp8(model, on=True):
    for m in model.modules():
        if isinstance(m, _Precision):
            m.fp8 = on
    return model
