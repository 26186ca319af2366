"""ResNet-style feature backbone (``nmrf_tpu/models/backbone.py``; reference
``nmrf/models/backbone.py:16-98``).  Channel-last [B, H, W, C] throughout;
outputs a [1/4-res, 1/8-res] feature pyramid."""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, instance_norm_2d


def _in(x, dtype):
    y = instance_norm_2d(x)
    return y.to(dtype) if dtype is not None else y


class ResidualBlock(nn.Module):
    """conv3x3(stride)-IN-relu -> conv3x3-IN-relu -> +identity -> relu
    (reference ``backbone.py:16-45``)."""

    def __init__(self, in_planes, planes, stride=1, dilation=1, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride,
                            padding=dilation, dilation=dilation, bias=False,
                            dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, padding=dilation,
                            dilation=dilation, bias=False, dtype=dtype)
        self.downsample = None
        if not (stride == 1 and in_planes == planes):
            # index 0 of the reference's Sequential(conv, norm)
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride, dtype=dtype))

    def forward(self, x):
        y = torch.relu(_in(self.conv1(x), self.dtype))
        y = torch.relu(_in(self.conv2(y), self.dtype))
        identity = x
        if self.downsample is not None:
            identity = _in(self.downsample(x), self.dtype)
        return torch.relu(y + identity)


class Backbone(nn.Module):
    """CNN backbone (reference ``backbone.py:48-98``).

    Input [B, H, W, 3] in 0..255, normalized to [-1, 1] internally (in bf16
    under a bf16 compute dtype, as the JAX package does).  Returns
    [1/4-res [B, H/4, W/4, out], 1/8-res average-pooled] (high to low).
    """

    def __init__(self, output_dim=256, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            dtype=dtype)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, dtype=dtype),
                                    ResidualBlock(64, 64, dtype=dtype))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, stride=2, dtype=dtype),
                                    ResidualBlock(96, 96, dtype=dtype))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, dtype=dtype),
                                    ResidualBlock(128, 128, dtype=dtype))
        self.conv2 = Conv2d(128, output_dim, 1, dtype=dtype)

    def forward(self, x):
        if self.dtype is not None:
            dt = self.dtype
            x = x.to(dt) * torch.tensor(2.0 / 255.0, dtype=dt) \
                - torch.tensor(1.0, dtype=dt)
        else:
            x = 2.0 * (x / 255.0) - 1.0
        x = torch.relu(_in(self.conv1(x), self.dtype))
        x = self.layer3(self.layer2(self.layer1(x)))
        x = self.conv2(x)
        pooled = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return [x, pooled]
