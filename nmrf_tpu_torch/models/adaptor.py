"""Swin backbone adaptor: Swin-T and the DeformNeck of multi-scale deformable
attention (``nmrf_tpu/models/adaptor.py``; reference
``ops/modules/ms_deform_attn.py`` and ``nmrf/models/adaptor_modules.py``,
``backbone.py:101-158``).  Channel-last; module names follow the reference's
``state_dict`` keys.

The DeformNeck's queries are the 1/4-resolution pixel grid, and its four
levels are that grid or 2, 4 and 8 times coarser, so with a tap radius the
sampling goes through the tap path (kernel B5 on CUDA tensors when
``use_kernels``); otherwise through the exact gather path.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.msda import (ms_deform_attn, ms_deform_attn_taps,
                        tap_out_of_range_fractions)
from .layers import (GELU, Conv2d, DropPath, LayerNorm, Linear,
                     instance_norm_2d, to_dtype)
from .swin import SwinTransformer

ADAPTOR_NORM_EPS = 1e-6  # reference adaptor_modules.py:74


def offset_bias_init(n_heads, n_levels, n_points):
    """Directional grid bias of ``sampling_offsets`` (reference
    ``ms_deform_attn.py:64-75``): head m points along angle 2*pi*m/M, point
    p at p + 1 pixels (at most 4 at init)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(n_heads, 1, 1, 2), (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention (reference ``ms_deform_attn.py:28-130``).
    The sampling offsets and attention weights run in float32 on the
    float32-cast query, whatever the compute dtype; the weights are cast to
    the value dtype before the sampling, as in the JAX package.

    With ``monitor_oob`` set (the train step's ``monitor_oob``), a forward
    on the tap path leaves in ``oob`` the share of its samples beyond the
    tap radius per level (``tap_out_of_range_fractions``, a [L] device
    tensor), whose largest the JAX package sows as ``msda_tap_oob``: kept
    per level so that a data-parallel step can average each over the data
    shards before the maximum; otherwise nothing is computed."""

    def __init__(self, d_model=256, n_levels=4, n_heads=8, n_points=4,
                 ratio=1.0, tap_radius=0, use_kernels=False, dtype=None):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.tap_radius, self.use_kernels = tap_radius, use_kernels
        self.monitor_oob, self.oob = False, None
        self.v_dim = int(d_model * ratio)
        self.value_proj = Linear(d_model, self.v_dim, dtype=dtype)
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = Linear(self.v_dim, d_model, dtype=dtype)

    def sampling(self, query, reference_points, spatial_shapes):
        """Sampling locations [B, Lq, M, L, P, 2] (x, y in [0, 1]) and
        softmax attention weights [B, Lq, M, L, P], both float32."""
        B, Lq, _ = query.shape
        M, L, P = self.n_heads, self.n_levels, self.n_points
        q = query.float()
        offsets = self.sampling_offsets(q).reshape(B, Lq, M, L, P, 2)
        weights = torch.softmax(
            self.attention_weights(q).reshape(B, Lq, M, L * P), dim=-1)
        normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                                  dtype=torch.float32, device=q.device)
        locations = (reference_points[:, :, None, :, None, :]
                     + offsets / normalizer[None, None, None, :, None, :])
        return locations, weights.reshape(B, Lq, M, L, P)

    def uses_taps(self, Lq, spatial_shapes, query_shape):
        """Whether the tap path applies (``adaptor.py:103-107``): a tap
        radius, and a query grid that is a whole multiple, by one factor on
        both axes, of every level."""
        if self.tap_radius <= 0 or query_shape is None:
            return False
        Hq, Wq = query_shape
        return Lq == Hq * Wq and all(
            Hq % h == 0 and Wq % w == 0 and Hq // h == Wq // w
            for h, w in spatial_shapes)

    def forward(self, query, reference_points, input_flatten, spatial_shapes,
                query_shape=None):
        """query: [B, Lq, C]; reference_points: [B or 1, Lq, L, 2] in [0, 1];
        input_flatten: [B, S, C]; spatial_shapes: [(H, W)] per level;
        query_shape: (Hq, Wq) when the queries form a regular grid."""
        B, Lq, _ = query.shape
        S = input_flatten.shape[1]
        value = self.value_proj(input_flatten)
        value = value.reshape(B, S, self.n_heads, self.v_dim // self.n_heads)
        locations, weights = self.sampling(query, reference_points,
                                           spatial_shapes)
        weights = weights.to(value.dtype)
        if self.uses_taps(Lq, spatial_shapes, query_shape):
            if self.monitor_oob:
                with torch.no_grad():
                    self.oob = tap_out_of_range_fractions(
                        locations, spatial_shapes, tuple(query_shape),
                        self.tap_radius)
            out = ms_deform_attn_taps(value, spatial_shapes, locations, weights,
                                      tuple(query_shape), self.tap_radius,
                                      self.use_kernels)
        else:
            out = ms_deform_attn(value, spatial_shapes, locations, weights)
        return self.output_proj(out)


class DWConv(nn.Module):
    """Depthwise 3x3 convolution with bias (reference ``DWConv``)."""

    def __init__(self, dim, dtype=None):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim, dtype=dtype)

    def forward(self, x):
        return self.dwconv(x)


class ConvFFN(nn.Module):
    """Linear -> depthwise 3x3 -> GELU -> Linear (reference
    ``adaptor_modules.py:37-68``)."""

    def __init__(self, in_features, hidden, out, gelu_approx=False, dtype=None):
        super().__init__()
        self.hidden = hidden
        self.fc1 = Linear(in_features, hidden, dtype=dtype)
        self.dwconv = DWConv(hidden, dtype=dtype)
        self.act = GELU(gelu_approx)
        self.fc2 = Linear(hidden, out, dtype=dtype)

    def forward(self, x, H, W):
        B, N, _ = x.shape
        x = self.dwconv(self.fc1(x).reshape(B, H, W, self.hidden))
        return self.fc2(self.act(x.reshape(B, N, self.hidden)))


class Extractor(nn.Module):
    """Deformable cross-attention extractor (reference
    ``adaptor_modules.py:71-105``): the query grid attends to one feature
    level, then a ConvFFN, each with a residual."""

    def __init__(self, dim, num_heads=8, n_points=4, n_levels=1,
                 deform_ratio=1.0, cffn_ratio=0.25, drop_path=0.0,
                 tap_radius=0, use_kernels=False, gelu_approx=False,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.query_norm = LayerNorm(dim, eps=ADAPTOR_NORM_EPS)
        self.feat_norm = LayerNorm(dim, eps=ADAPTOR_NORM_EPS)
        self.attn = MSDeformAttn(dim, n_levels, num_heads, n_points,
                                 deform_ratio, tap_radius, use_kernels, dtype)
        self.ffn = ConvFFN(dim, int(dim * cffn_ratio), dim, gelu_approx, dtype)
        self.ffn_norm = LayerNorm(dim, eps=ADAPTOR_NORM_EPS)
        self.drop_path = DropPath(drop_path)

    def forward(self, query, reference_points, feat, spatial_shapes, H, W):
        attn = self.attn(to_dtype(self.query_norm(query), self.dtype),
                         reference_points,
                         to_dtype(self.feat_norm(feat), self.dtype),
                         spatial_shapes, (H, W))
        query = query + attn
        ffn = self.ffn(to_dtype(self.ffn_norm(query), self.dtype), H, W)
        return query + self.drop_path(ffn)


class ConvStem(nn.Module):
    """Three 3x3 convolutions (strides 2, 1, 1) with instance norm and ReLU,
    a 3x3 stride-2 max pool and a 1x1 projection: the 1/4-resolution query
    map, flattened (reference ``adaptor_modules.py:108-142``; the
    convolutions sit at indices 0, 3 and 6 of the reference's Sequential)."""

    def __init__(self, inplanes=64, out_channels=256, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.stem = nn.ModuleDict({
            "0": Conv2d(3, inplanes, 3, stride=2, padding=1, bias=False, dtype=dtype),
            "3": Conv2d(inplanes, inplanes, 3, padding=1, bias=False, dtype=dtype),
            "6": Conv2d(inplanes, inplanes, 3, padding=1, bias=False, dtype=dtype),
        })
        self.fc = Conv2d(inplanes, out_channels, 1, dtype=dtype)

    def forward(self, x):
        x = to_dtype(x, self.dtype)
        for conv in self.stem.values():
            x = torch.relu(to_dtype(instance_norm_2d(conv(x)), self.dtype))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        x = self.fc(x)
        B, H, W, C = x.shape
        return x.reshape(B, H * W, C)


def get_reference_points(spatial_shapes, device=None):
    """Pixel-centre reference grid in [0, 1], [1, sum H*W, 1, 2] (x, y)
    (reference ``adaptor_modules.py:10-22``)."""
    pts = []
    for H, W in spatial_shapes:
        ry, rx = np.meshgrid(np.linspace(0.5, H - 0.5, H) / H,
                             np.linspace(0.5, W - 0.5, W) / W, indexing="ij")
        pts.append(np.stack([rx.reshape(-1), ry.reshape(-1)], -1))
    pts = np.concatenate(pts, 0).astype(np.float32)
    return torch.as_tensor(pts, device=device)[None, :, None]


class DeformNeck(nn.Module):
    """ConvStem query map and one extractor per pyramid level (reference
    ``adaptor_modules.py:145-188``): each level is normed and projected to
    ``dim`` (``fcs``), then the queries attend to it."""

    def __init__(self, dim, in_channel_list, num_heads=8, n_points=4,
                 drop_path=0.0, cffn_ratio=0.25, deform_ratio=1.0,
                 tap_radius=0, use_kernels=False, gelu_approx=False,
                 dtype=None):
        super().__init__()
        self.dim = dim
        self.stem = ConvStem(64, dim, dtype=dtype)
        self.fcs = nn.ModuleList(
            nn.Sequential(LayerNorm(c, eps=ADAPTOR_NORM_EPS),
                          Linear(c, dim, dtype=dtype))
            for c in in_channel_list)
        self.extractors = nn.ModuleList(
            Extractor(dim, num_heads, n_points, 1, deform_ratio, cffn_ratio,
                      drop_path, tap_radius, use_kernels, gelu_approx, dtype)
            for _ in in_channel_list)

    def forward(self, image, features):
        """image: [B, H, W, 3]; features: [p0..p3] -> [B, H/4, W/4, dim]."""
        B, H_img, W_img, _ = image.shape
        H, W = H_img // 4, W_img // 4
        c = self.stem(image)
        ref = get_reference_points([(H, W)], image.device)
        for fc, extractor, feat in zip(self.fcs, self.extractors, features):
            fb, fh, fw, fch = feat.shape
            flat = fc(feat.reshape(fb, fh * fw, fch))
            c = extractor(c, ref, flat, [(fh, fw)], H, W)
        return c.reshape(B, H, W, self.dim)


# ImageNet normalization (reference backbone.py:123-128)
IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


class SwinAdaptor(nn.Module):
    """Swin-T + DeformNeck backbone (reference ``backbone.py:101-158``).
    Input [B, H, W, 3] in 0..255, ImageNet-normalized out of place (in bf16
    under a bf16 compute dtype, in the JAX package's order).  Returns
    [1/4-res [B, H/4, W/4, out], its 2x2 average pool]."""

    def __init__(self, out_channels, drop_path_rate=0.0, tap_radius=0,
                 use_kernels=False, gelu_approx=False, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.backbone = SwinTransformer(drop_path_rate=drop_path_rate,
                                        gelu_approx=gelu_approx, dtype=dtype)
        self.neck = DeformNeck(out_channels, [96, 192, 384, 768],
                               deform_ratio=0.5, tap_radius=tap_radius,
                               use_kernels=use_kernels,
                               gelu_approx=gelu_approx, dtype=dtype)

    def forward(self, x):
        mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
        if self.dtype is not None:
            inv_std = torch.as_tensor(1.0 / IMAGENET_STD, device=x.device)
            x = (x.to(self.dtype) - mean.to(self.dtype)) * inv_std.to(self.dtype)
        else:
            x = (x - mean) / torch.as_tensor(IMAGENET_STD, device=x.device)
        out = self.neck(x, self.backbone(x))
        pooled = F.avg_pool2d(out.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return [out, pooled]
