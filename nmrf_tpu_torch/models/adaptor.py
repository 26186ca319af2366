"""Swin backbone adaptor: Swin-T and the DeformNeck of multi-scale deformable
attention (``nmrf_tpu/models/adaptor.py``; reference
``ops/modules/ms_deform_attn.py`` and ``nmrf/models/adaptor_modules.py``,
``backbone.py:101-158``).  Channel-last; module names follow the reference's
``state_dict`` keys.

The DeformNeck's queries are the 1/4-resolution pixel grid, and its four
levels are that grid or 2, 4 and 8 times coarser, so with a tap radius the
sampling goes through the tap path (kernel B5 on CUDA tensors when
``use_kernels``); otherwise through the exact gather path.

With a spatial group (``parallel/spatial.py``) the input is an H tile of
the images, and the backbone returns the tile's rows of both levels:
Swin-T on its tiles (``models/swin.py``); the ConvStem's convolutions and
its max pool with halo rows (site ``stem_halo``; the pool's zero halo at
the global edges is exact, its inputs being post-ReLU) and its instance
norms with global moments (``stem_moments``); the DeformNeck's queries are
the tile's 1/4-resolution rows, their reference points global, and each
level's value map is exchanged after ``value_proj`` for the rows that the
tile's taps reach, its base rows +- (radius + 1) (``msda_halo``), or
all-gathered where it is whole elsewhere (the exact gather path, or a
tile with fewer rows than that halo: ``msda_value``); a level that Swin
ran whole is whole on every rank already.  ConvFFN's depthwise 3x3 takes a
1-row halo (``ffn_halo``).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.constants import device_constant
from ..ops.msda import (ms_deform_attn, ms_deform_attn_taps,
                        tap_out_of_range_fractions)
from ..parallel.spatial import all_gather_h, halo_exchange_h
from . import graphs
from .layers import (GELU, Conv2d, DropPath, LayerNorm, Linear,
                     instance_norm, to_dtype)
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


class TileRows:
    """Where the queries and value maps of an H tile lie: the spatial
    ``group``, the queries' first global row ``q0``, and per level
    ``value_rows`` (v0, n): the level map's n local rows are its global
    rows from v0 (the tile's rows, or the whole level)."""

    def __init__(self, group, q0, value_rows):
        self.group, self.q0, self.value_rows = group, q0, value_rows


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
        normalizer = device_constant(
            _level_sizes, (tuple(tuple(s) for s in spatial_shapes),),
            q.device, torch.float32)
        locations = (reference_points[:, :, None, :, None, :]
                     + offsets / normalizer[None, None, None, :, None, :])
        return locations, weights.reshape(B, Lq, M, L, P)

    def uses_taps(self, Lq, spatial_shapes, query_shape):
        """Whether the tap path applies (``adaptor.py:103-107``): a tap
        radius, and a query grid that is a whole multiple, by one factor on
        both axes, of every level (Lq of its rows: all, or an H tile's)."""
        if self.tap_radius <= 0 or query_shape is None:
            return False
        Hq, Wq = query_shape
        return Lq % Wq == 0 and Lq <= Hq * Wq and all(
            Hq % h == 0 and Wq % w == 0 and Hq // h == Wq // w
            for h, w in spatial_shapes)

    def forward(self, query, reference_points, input_flatten, spatial_shapes,
                query_shape=None, rows=None):
        """query: [B, Lq, C]; reference_points: [B or 1, Lq, L, 2] in [0, 1];
        input_flatten: [B, S, C]; spatial_shapes: [(H, W)] per level;
        query_shape: (Hq, Wq) when the queries form a regular grid.

        rows: a :class:`TileRows` when the queries are an H tile's rows of
        that grid and each level's map in input_flatten is its rows of
        ``rows.value_rows``; spatial_shapes and query_shape stay global."""
        B, Lq, _ = query.shape
        S = input_flatten.shape[1]
        value = self.value_proj(input_flatten)
        value = value.reshape(B, S, self.n_heads, self.v_dim // self.n_heads)
        locations, weights = self.sampling(query, reference_points,
                                           spatial_shapes)
        weights = weights.to(value.dtype)
        taps = self.uses_taps(Lq, spatial_shapes, query_shape)
        q0, value_rows = 0, None
        if rows is not None:
            value, value_rows = self._tile_values(value, spatial_shapes, rows,
                                                  taps)
            q0 = rows.q0
        if taps:
            local = (Lq // query_shape[1], query_shape[1])
            if self.monitor_oob:
                with torch.no_grad():
                    self.oob = tap_out_of_range_fractions(
                        locations, spatial_shapes, local, self.tap_radius, q0)
            out = ms_deform_attn_taps(value, spatial_shapes, locations, weights,
                                      local, self.tap_radius,
                                      self.use_kernels, q0, value_rows)
        else:
            out = ms_deform_attn(value, spatial_shapes, locations, weights)
        return self.output_proj(out)

    def _tile_values(self, value, spatial_shapes, rows, taps):
        """The level maps an H tile's queries read: on the tap path each
        tiled level with halo rows of radius + 1 (base rows +- (r + 1)),
        else the whole level; returns the value [B, S', M, D] and each
        level's (v0, n)."""
        B, _, M, D = value.shape
        maps, value_rows, start = [], [], 0
        for (H, W), (v0, n) in zip(spatial_shapes, rows.value_rows):
            vmap = value[:, start:start + n * W].reshape(B, n, W, M * D)
            start += n * W
            halo = self.tap_radius + 1
            if n < H and taps and halo <= n:
                vmap = halo_exchange_h(vmap, halo, rows.group, site="msda_halo")
                v0, n = v0 - halo, n + 2 * halo
            elif n < H:
                vmap = all_gather_h(vmap, rows.group, site="msda_value")
                v0, n = 0, H
            maps.append(vmap.reshape(B, n * W, M, D))
            value_rows.append((v0, n))
        return torch.cat(maps, 1) if len(maps) > 1 else maps[0], value_rows


class DWConv(nn.Module):
    """Depthwise 3x3 convolution with bias (reference ``DWConv``); on an H
    tile with a 1-row halo."""

    def __init__(self, dim, dtype=None, spatial=None):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim, dtype=dtype,
                             spatial=spatial, site="ffn_halo")

    def forward(self, x):
        return self.dwconv(x)


class ConvFFN(nn.Module):
    """Linear -> depthwise 3x3 -> GELU -> Linear (reference
    ``adaptor_modules.py:37-68``)."""

    def __init__(self, in_features, hidden, out, gelu_approx=False, dtype=None,
                 spatial=None):
        super().__init__()
        self.hidden = hidden
        self.fc1 = Linear(in_features, hidden, dtype=dtype)
        self.dwconv = DWConv(hidden, dtype=dtype, spatial=spatial)
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
                 dtype=None, spatial=None):
        super().__init__()
        self.dtype = dtype
        self.query_norm = LayerNorm(dim, eps=ADAPTOR_NORM_EPS)
        self.feat_norm = LayerNorm(dim, eps=ADAPTOR_NORM_EPS)
        self.attn = MSDeformAttn(dim, n_levels, num_heads, n_points,
                                 deform_ratio, tap_radius, use_kernels, dtype)
        self.ffn = ConvFFN(dim, int(dim * cffn_ratio), dim, gelu_approx, dtype,
                           spatial)
        self.ffn_norm = LayerNorm(dim, eps=ADAPTOR_NORM_EPS)
        self.drop_path = DropPath(drop_path)

    def forward(self, query, reference_points, feat, spatial_shapes, H, W,
                rows=None):
        """H, W: the query grid (global); with ``rows`` (a
        :class:`TileRows`) the queries are its tile's rows."""
        attn = self.attn(to_dtype(self.query_norm(query), self.dtype),
                         reference_points,
                         to_dtype(self.feat_norm(feat), self.dtype),
                         spatial_shapes, (H, W), rows=rows)
        query = query + attn
        h = H if rows is None else query.shape[1] // W
        ffn = self.ffn(to_dtype(self.ffn_norm(query), self.dtype), h, W)
        return query + self.drop_path(ffn)


class ConvStem(nn.Module):
    """Three 3x3 convolutions (strides 2, 1, 1) with instance norm and ReLU,
    a 3x3 stride-2 max pool and a 1x1 projection: the 1/4-resolution query
    map, flattened (reference ``adaptor_modules.py:108-142``; the
    convolutions sit at indices 0, 3 and 6 of the reference's Sequential)."""

    def __init__(self, inplanes=64, out_channels=256, dtype=None, spatial=None):
        super().__init__()
        self.dtype = dtype
        self.spatial = spatial
        conv = dict(padding=1, bias=False, dtype=dtype, spatial=spatial,
                    site="stem_halo")
        self.stem = nn.ModuleDict({
            "0": Conv2d(3, inplanes, 3, stride=2, **conv),
            "3": Conv2d(inplanes, inplanes, 3, **conv),
            "6": Conv2d(inplanes, inplanes, 3, **conv),
        })
        self.fc = Conv2d(inplanes, out_channels, 1, dtype=dtype)

    def forward(self, x):
        x = to_dtype(x, self.dtype)
        for conv in self.stem.values():
            x = torch.relu(to_dtype(instance_norm(conv(x), self.spatial,
                                                  "stem_moments"), self.dtype))
        if self.spatial is None:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1)
        else:  # output row o reads rows 2o - 1 .. 2o + 1: one row above
            x = halo_exchange_h(x, 1, self.spatial, site="stem_halo")
            x = F.max_pool2d(x[:, :-1].permute(0, 3, 1, 2), 3, 2, (0, 1))
        x = self.fc(x.permute(0, 2, 3, 1))
        B, H, W, C = x.shape
        return x.reshape(B, H * W, C)


def _level_sizes(spatial_shapes):
    return [[w, h] for h, w in spatial_shapes]


def get_reference_points(spatial_shapes, device=None, rows=None):
    """Pixel-centre reference grid in [0, 1], [1, sum H*W, 1, 2] (x, y)
    (reference ``adaptor_modules.py:10-22``); ``rows`` (r0, n): only the
    global rows r0 .. r0 + n - 1 of each level (an H tile's)."""
    return device_constant(
        _reference_points, (tuple(tuple(s) for s in spatial_shapes),
                            None if rows is None else tuple(rows)),
        device or "cpu")[None, :, None]


def _reference_points(spatial_shapes, rows):
    pts = []
    for H, W in spatial_shapes:
        ry, rx = np.meshgrid(np.linspace(0.5, H - 0.5, H) / H,
                             np.linspace(0.5, W - 0.5, W) / W, indexing="ij")
        if rows is not None:
            ry, rx = ry[rows[0]:rows[0] + rows[1]], rx[rows[0]:rows[0] + rows[1]]
        pts.append(np.stack([rx.reshape(-1), ry.reshape(-1)], -1))
    return np.concatenate(pts, 0).astype(np.float32)


class DeformNeck(nn.Module):
    """ConvStem query map and one extractor per pyramid level (reference
    ``adaptor_modules.py:145-188``): each level is normed and projected to
    ``dim`` (``fcs``), then the queries attend to it.  spatial: the
    spatial group when the image is an H tile (module docstring)."""

    def __init__(self, dim, in_channel_list, num_heads=8, n_points=4,
                 drop_path=0.0, cffn_ratio=0.25, deform_ratio=1.0,
                 tap_radius=0, use_kernels=False, gelu_approx=False,
                 dtype=None, spatial=None):
        super().__init__()
        self.dim = dim
        self.spatial = spatial
        self.stem = ConvStem(64, dim, dtype=dtype, spatial=spatial)
        self.fcs = nn.ModuleList(
            nn.Sequential(LayerNorm(c, eps=ADAPTOR_NORM_EPS),
                          Linear(c, dim, dtype=dtype))
            for c in in_channel_list)
        self.extractors = nn.ModuleList(
            Extractor(dim, num_heads, n_points, 1, deform_ratio, cffn_ratio,
                      drop_path, tap_radius, use_kernels, gelu_approx, dtype,
                      spatial)
            for _ in in_channel_list)

    def forward(self, image, features):
        """image: [B, H, W, 3]; features: [p0..p3] -> [B, H/4, W/4, dim];
        on an H tile the tile's rows of each, a level whole where Swin ran
        its stage whole."""
        B, H_img, W_img, _ = image.shape
        h, W = H_img // 4, W_img // 4
        sp = self.spatial
        H = h if sp is None else h * sp.size
        c = self.stem(image)
        ref = get_reference_points([(H, W)], image.device,
                                   None if sp is None else (sp.index * h, h))
        for fc, extractor, feat in zip(self.fcs, self.extractors, features):
            fb, fh, fw, fch = feat.shape
            flat = fc(feat.reshape(fb, fh * fw, fch))
            rows, shape = None, (fh, fw)
            if sp is not None:  # a level is whole where Swin ran it whole
                tiled = fh * (W // fw) < H
                shape = (fh * sp.size if tiled else fh, fw)
                rows = TileRows(sp, sp.index * h,
                                [(sp.index * fh if tiled else 0, fh)])
            c = extractor(c, ref, flat, [shape], H, W, rows)
        return c.reshape(B, h, W, self.dim)


# ImageNet normalization (reference backbone.py:123-128)
IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def _imagenet(stat):
    return {"mean": IMAGENET_MEAN, "std": IMAGENET_STD,
            "inv_std": 1.0 / IMAGENET_STD}[stat]


class SwinAdaptor(nn.Module):
    """Swin-T + DeformNeck backbone (reference ``backbone.py:101-158``).
    Input [B, H, W, 3] in 0..255, ImageNet-normalized out of place (in bf16
    under a bf16 compute dtype, in the JAX package's order).  Returns
    [1/4-res [B, H/4, W/4, out], its 2x2 average pool]."""

    def __init__(self, out_channels, drop_path_rate=0.0, tap_radius=0,
                 use_kernels=False, gelu_approx=False, dtype=None,
                 spatial=None):
        super().__init__()
        self.dtype = dtype
        self.spatial = spatial
        self.backbone = SwinTransformer(drop_path_rate=drop_path_rate,
                                        gelu_approx=gelu_approx, dtype=dtype,
                                        spatial=spatial)
        self.neck = DeformNeck(out_channels, [96, 192, 384, 768],
                               deform_ratio=0.5, tap_radius=tap_radius,
                               use_kernels=use_kernels,
                               gelu_approx=gelu_approx, dtype=dtype,
                               spatial=spatial)

    def forward(self, x, replay=None):
        """``replay``: the forward's ``graphs.Segments`` on the graph path,
        which replays :meth:`features` and returns fresh copies."""
        return graphs.call(replay, "backbone", self.features, x)

    def features(self, x):
        mean = device_constant(_imagenet, ("mean",), x.device)
        if self.dtype is not None:
            inv_std = device_constant(_imagenet, ("inv_std",), x.device)
            x = (x.to(self.dtype) - mean.to(self.dtype)) * inv_std.to(self.dtype)
        else:
            x = (x - mean) / device_constant(_imagenet, ("std",), x.device)
        out = self.neck(x, self.backbone(x))
        pooled = F.avg_pool2d(out.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return [out, pooled]
