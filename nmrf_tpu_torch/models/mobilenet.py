"""MobileNetV2's trunk (Sandler et al., "MobileNetV2: Inverted Residuals and
Linear Bottlenecks", CVPR 2018, arXiv:1801.04381) in timm's
``mobilenetv2_100`` layout, as IGEV-Stereo's ``Feature`` holds it
(``models/igev_stereo.py``): a ReLU6 stem of 32 channels at 1/2, then the
blocks of its stages 0-5, 16/24/32/64/96/160 channels at strides
1/2/2/2/1/2 (stage 6, 320 channels, is not built: IGEV-Stereo reads none of
it).

Module names are timm's (``conv_dw``, ``bn1``, ``conv_pw``, ...), so a
converted checkpoint of timm's model loads.  Channel-last [B, H, W, C];
convolutions (the depthwise ones with ``groups``) in the compute dtype, the
batch norms in float32 (eval mode, running statistics), each norm's output
cast back to the compute dtype before its ReLU6 and the residual sum."""

import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, Conv2d, to_dtype

# (blocks, stride of the first, expansion, channels) of stages 0-5
STAGES = ((1, 1, 1, 16), (2, 2, 6, 24), (3, 2, 6, 32), (4, 2, 6, 64),
          (3, 1, 6, 96), (3, 2, 6, 160))
STEM = 32


def _bn(bn, x, dtype, relu6=True):
    x = to_dtype(bn(x), dtype)
    return F.relu6(x) if relu6 else x


class DepthwiseSeparable(nn.Module):
    """Stage 0's block: depthwise 3x3 -> BN -> ReLU6 -> 1x1 -> BN (no
    activation, no residual: the channels change)."""

    def __init__(self, in_ch, out_ch, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv_dw = Conv2d(in_ch, in_ch, 3, padding=1, groups=in_ch,
                              bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(in_ch)
        self.conv_pw = Conv2d(in_ch, out_ch, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(out_ch)

    def forward(self, x):
        x = _bn(self.bn1, self.conv_dw(x), self.dtype)
        return _bn(self.bn2, self.conv_pw(x), self.dtype, relu6=False)


class InvertedResidual(nn.Module):
    """1x1 expansion -> BN -> ReLU6 -> depthwise 3x3 (stride) -> BN -> ReLU6
    -> 1x1 projection -> BN, plus the input where the stride is 1 and the
    channels stay."""

    def __init__(self, in_ch, out_ch, stride, expansion, dtype=None):
        super().__init__()
        self.dtype = dtype
        mid = in_ch * expansion
        self.skip = stride == 1 and in_ch == out_ch
        self.conv_pw = Conv2d(in_ch, mid, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(mid)
        self.conv_dw = Conv2d(mid, mid, 3, stride=stride, padding=1,
                              groups=mid, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(mid)
        self.conv_pwl = Conv2d(mid, out_ch, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(out_ch)

    def forward(self, x):
        y = _bn(self.bn1, self.conv_pw(x), self.dtype)
        y = _bn(self.bn2, self.conv_dw(y), self.dtype)
        y = _bn(self.bn3, self.conv_pwl(y), self.dtype, relu6=False)
        return to_dtype(x, self.dtype) + y if self.skip else y


def stages(dtype=None):
    """timm's ``blocks[0:6]``: one ``nn.Sequential`` of blocks a stage."""
    out, in_ch = [], STEM
    for i, (n, stride, expansion, ch) in enumerate(STAGES):
        if i == 0:
            blocks = [DepthwiseSeparable(in_ch, ch, dtype)]
        else:
            blocks = [InvertedResidual(in_ch if j == 0 else ch, ch,
                                       stride if j == 0 else 1, expansion,
                                       dtype) for j in range(n)]
        out.append(nn.Sequential(*blocks))
        in_ch = ch
    return out
