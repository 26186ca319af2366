"""ResNet-style feature backbone (``nmrf_tpu/models/backbone.py``; reference
``nmrf/models/backbone.py:16-98``).  Channel-last [B, H, W, C] throughout;
outputs a [1/4-res, 1/8-res] feature pyramid.

With a spatial group (``parallel/spatial.py``) the input is an H tile of
the images and the outputs are the tile's rows of both levels: each
convolution takes the rows it reads beyond the tile from the neighbour
tiles (``layers.Conv2d``: 3 above and 2 below for the 7x7 stride-2 stem, 1
each side for a 3x3 at stride 1, 1 above for ``layer2``'s stride-2 3x3,
none for a 1x1) and every instance norm takes the group's global moments.
The tile height must be a multiple of 8, so that each stride-2 layer's
tile starts on an even global row and the 1/4 tile pools in whole 2x2
blocks."""

import torch
import torch.nn.functional as F
from torch import nn

from . import graphs
from .layers import Conv2d, instance_norm


def _in(x, dtype, spatial):
    y = instance_norm(x, spatial)
    return y.to(dtype) if dtype is not None else y


class ResidualBlock(nn.Module):
    """conv3x3(stride)-IN-relu -> conv3x3-IN-relu -> +identity -> relu
    (reference ``backbone.py:16-45``)."""

    def __init__(self, in_planes, planes, stride=1, dilation=1, dtype=None,
                 spatial=None):
        super().__init__()
        self.dtype = dtype
        self.spatial = spatial
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride,
                            padding=dilation, dilation=dilation, bias=False,
                            dtype=dtype, spatial=spatial)
        self.conv2 = Conv2d(planes, planes, 3, padding=dilation,
                            dilation=dilation, bias=False, dtype=dtype,
                            spatial=spatial)
        self.downsample = None
        if not (stride == 1 and in_planes == planes):
            # index 0 of the reference's Sequential(conv, norm)
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride, dtype=dtype,
                       spatial=spatial))

    def forward(self, x):
        y = torch.relu(_in(self.conv1(x), self.dtype, self.spatial))
        y = torch.relu(_in(self.conv2(y), self.dtype, self.spatial))
        identity = x
        if self.downsample is not None:
            identity = _in(self.downsample(x), self.dtype, self.spatial)
        return torch.relu(y + identity)


class Backbone(nn.Module):
    """CNN backbone (reference ``backbone.py:48-98``).

    Input [B, H, W, 3] in 0..255, normalized to [-1, 1] internally (in bf16
    under a bf16 compute dtype, as the JAX package does).  Returns
    [1/4-res [B, H/4, W/4, out], 1/8-res average-pooled] (high to low).
    spatial: the spatial group when the input is an H tile (module
    docstring).
    """

    def __init__(self, output_dim=256, dtype=None, spatial=None):
        super().__init__()
        self.dtype = dtype
        self.spatial = spatial
        block = dict(dtype=dtype, spatial=spatial)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            **block)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, **block),
                                    ResidualBlock(64, 64, **block))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, stride=2, **block),
                                    ResidualBlock(96, 96, **block))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, **block),
                                    ResidualBlock(128, 128, **block))
        self.conv2 = Conv2d(128, output_dim, 1, dtype=dtype)

    def forward(self, x, replay=None):
        """``replay``: the forward's ``graphs.Segments`` on the graph path,
        which replays :meth:`features` and returns fresh copies."""
        return graphs.call(replay, "backbone", self.features, x)

    def features(self, x):
        if self.dtype is not None:
            dt = self.dtype
            x = x.to(dt) * torch.tensor(2.0 / 255.0, dtype=dt) \
                - torch.tensor(1.0, dtype=dt)
        else:
            x = 2.0 * (x / 255.0) - 1.0
        x = torch.relu(_in(self.conv1(x), self.dtype, self.spatial))
        x = self.layer3(self.layer2(self.layer1(x)))
        x = self.conv2(x)
        pooled = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return [x, pooled]
