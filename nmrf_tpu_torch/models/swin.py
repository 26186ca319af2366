"""Swin-T backbone (``nmrf_tpu/models/swin.py``; reference
``nmrf/models/swin.py``): patch embedding 4, depths (2, 2, 6, 2), heads
(3, 6, 12, 24), window 7, relative-position bias, -100.0 shifted-window mask
fill, no output norms.  Channel-last [B, H, W, C]; returns the [p0..p3]
pyramid at strides 4/8/16/32.  The window attention here is plain PyTorch,
as the JAX package computes it outside any Pallas kernel.  Module names
follow the reference's ``state_dict`` keys.

With a spatial group (``parallel/spatial.py``) the input is an H tile of
the images and each stage runs on its tile of the stage's map while the
tile holds at least one window's rows (7) and, where a merge follows, an
even count (:func:`stage_on_tiles`); from the first stage that does not,
the stage's input is all-gathered (site ``swin_stage``) and it and the
later stages run whole on every rank.  The patch embedding, the norms, the
MLPs and the patch merging are per token (a merge of 2 x 2 tokens stays in
a tile of even rows).  The windows stay those of the whole map: they start
at multiples of 7 of the stage's padded global map (shifted blocks 3 rows
later, their last window wrapping the map's last rows onto its first
three), the bottom pad to a multiple of 7 lives on the last rank, and a
tile takes from its neighbours, after ``norm1``, the rows of the windows
that cover its own (:func:`tile_window_rows`, site ``swin_halo``; the
shifted blocks' exchange wraps).  A window cut by a tile edge is computed
by both ranks, each keeping its rows; the halo exchange's backward returns
the gradients of the rows it lent.  The shifted-window mask is indexed by
the global window rows."""

import logging
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import relative_position_index
from ..ops.constants import device_constant
from ..parallel.spatial import all_gather_h, halo_exchange_h
from .layers import GELU, Conv2d, DropPath, LayerNorm, Linear, Mlp, to_dtype

log = logging.getLogger(__name__)


@lru_cache(maxsize=32)
def swin_shift_mask(Hp, Wp, window_size, shift_size):
    """[nW, ws*ws, ws*ws] shifted-window mask of a padded Hp x Wp map:
    -100.0 between tokens of different shifted regions (reference
    ``swin.py:421-450``)."""
    img_mask = np.zeros((Hp, Wp))
    slices = (slice(0, -window_size), slice(-window_size, -shift_size),
              slice(-shift_size, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img_mask[hs, ws] = cnt
            cnt += 1
    mw = img_mask.reshape(Hp // window_size, window_size,
                          Wp // window_size, window_size)
    mw = mw.transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def stage_on_tiles(rows, window_size, merge):
    """Whether a stage runs on H tiles of ``rows`` rows each: at least a
    window's rows, and an even count when a patch merging follows."""
    return rows >= window_size and not (merge and rows % 2)


def tile_window_rows(index, n, rows, Hp, window_size, shift):
    """The rows (above, below) that tile ``index`` of ``n`` equal tiles of
    ``rows`` rows needs beyond its own to hold the whole windows covering
    them, on a stage map padded to Hp rows (the pad on the last tile):
    windows start at ``shift`` plus multiples of the window, modulo Hp."""
    t0 = index * rows
    t1 = Hp if index == n - 1 else t0 + rows
    return (t0 - shift) % window_size, (shift - t1) % window_size


class StageTile:
    """A Swin stage's H tile: the spatial group, and the stage map's rows
    (``rows`` a tile, ``H`` in all).  The tile's first global row is
    ``group.index * rows``; the last tile holds the bottom pad."""

    def __init__(self, group, rows):
        self.group, self.rows = group, rows
        self.H = rows * group.size

    def window_rows(self, window_size, shift):
        """(above, below) of this tile, and the halo every tile exchanges
        (the most any tile needs, so that all call one exchange)."""
        Hp = -(-self.H // window_size) * window_size
        need = [tile_window_rows(i, self.group.size, self.rows, Hp,
                                 window_size, shift)
                for i in range(self.group.size)]
        return need[self.group.index], max(max(a, b) for a, b in need), Hp


class WindowAttention(nn.Module):
    """Swin W-MSA with relative-position bias (reference ``swin.py:77-176``).
    Logits plus bias and mask, and the softmax, in float32; the
    probabilities are cast to v's dtype for the product with v."""

    def __init__(self, dim, window_size, num_heads, dtype=None):
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))

    def forward(self, x, mask=None):
        """x: [B_, N, C] windows; mask: [nW, N, N] or None."""
        B_, N, C = x.shape
        h = self.num_heads
        hd = C // h
        qkv = self.qkv(x).reshape(B_, N, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        attn = q @ k.transpose(-2, -1)
        ws = self.window_size
        idx = device_constant(relative_position_index, (ws, ws),
                              x.device).reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(N, N, h)
        attn = attn.float() + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(B_ // nW, nW, h, N, N) + mask[None, :, None]
            attn = attn.reshape(B_, h, N, N)
        attn = torch.softmax(attn, dim=-1)
        out = (attn.to(v.dtype) @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(out)


class SwinBlock(nn.Module):
    """Swin transformer block (reference ``swin.py:178-305``): pad to a
    multiple of the window, roll by -shift, window attention, unroll, crop;
    then the MLP, each with a residual through drop-path."""

    def __init__(self, dim, num_heads, window_size=7, shift_size=0,
                 mlp_ratio=4.0, drop_path=0.0, gelu_approx=False, dtype=None):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, dtype=dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, act=GELU(gelu_approx),
                       dtype=dtype)

    def forward(self, x, tile=None):
        """x: [B, H, W, C], or with ``tile`` (a :class:`StageTile`) the
        tile's rows of the stage map."""
        if tile is not None:
            return self._forward_tile(x, tile)
        B, H, W, C = x.shape
        ws, s = self.window_size, self.shift_size
        shortcut = x
        x = to_dtype(self.norm1(x), self.dtype)
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if s > 0:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
            mask = device_constant(swin_shift_mask, (Hp, Wp, ws, s), x.device)
        xw = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        a = self.attn(xw.reshape(-1, ws * ws, C), mask)
        x = a.reshape(B, Hp // ws, Wp // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, Hp, Wp, C)
        if s > 0:
            x = torch.roll(x, (s, s), dims=(1, 2))
        x = shortcut + self.drop_path(x[:, :H, :W])
        return x + self.drop_path(self.mlp(to_dtype(self.norm2(x), self.dtype)))

    def _forward_tile(self, x, tile):
        """The block on an H tile (module docstring): the tile, extended
        by the rows of the windows that cover it, attends in those windows
        (the shift on W a local roll) and keeps its own rows."""
        B, h, W, C = x.shape
        ws, s = self.window_size, self.shift_size
        (above, below), halo, Hp = tile.window_rows(ws, s)
        shortcut = x
        x = to_dtype(self.norm1(x), self.dtype)
        pad_r = (ws - W % ws) % ws
        last = tile.group.index == tile.group.size - 1
        x = F.pad(x, (0, 0, 0, pad_r, 0, Hp - tile.H if last else 0))
        Wp = W + pad_r
        if halo:
            x = halo_exchange_h(x, halo, tile.group, wrap=s > 0,
                                site="swin_halo")
            x = x.narrow(1, halo - above, x.shape[1] - 2 * halo + above + below)
        He = x.shape[1]
        mask = None
        if s > 0:
            x = torch.roll(x, -s, dims=2)
            # the global window rows of these windows, in the rolled map
            first = (tile.group.index * tile.rows - above - s) % Hp // ws
            rows = (first + np.arange(He // ws)) % (Hp // ws)
            mask = swin_shift_mask(Hp, Wp, ws, s).reshape(
                Hp // ws, Wp // ws, ws * ws, ws * ws)[rows]
            mask = torch.as_tensor(mask.reshape(-1, ws * ws, ws * ws),
                                   device=x.device)
        xw = x.reshape(B, He // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        a = self.attn(xw.reshape(-1, ws * ws, C), mask)
        x = a.reshape(B, He // ws, Wp // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, He, Wp, C)
        if s > 0:
            x = torch.roll(x, s, dims=2)
        x = shortcut + self.drop_path(x[:, above:above + h, :W])
        return x + self.drop_path(self.mlp(to_dtype(self.norm2(x), self.dtype)))


class PatchMerging(nn.Module):
    """2x2 patch merging (reference ``swin.py:308-345``): odd H/W padded,
    concatenation in the order (0::2, 0::2), (1::2, 0::2), (0::2, 1::2),
    (1::2, 1::2), then norm and a bias-free reduction to 2 * dim."""

    def __init__(self, dim, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x):
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(to_dtype(self.norm(x), self.dtype))


class PatchEmbed(nn.Module):
    """4x4 stride-4 convolution and a norm.  The model's inputs are padded
    to a multiple of 8 or 32, where the JAX package's "SAME" padding of this
    convolution is zero."""

    def __init__(self, embed_dim, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.proj = Conv2d(3, embed_dim, 4, stride=4, dtype=dtype)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x):
        return to_dtype(self.norm(self.proj(x)), self.dtype)


class BasicLayer(nn.Module):
    """One Swin stage: its blocks, then patch merging except at the last."""

    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """Swin-T pyramid backbone (reference ``swin.py:496-683``).  Input
    [B, H, W, 3] (already normalized); returns [p0, p1, p2, p3].  Drop-path
    rates rise linearly from 0 to ``drop_path_rate`` over the blocks.

    spatial: the spatial group when the input is an H tile (module
    docstring); each level is then the tile's rows of the stage map, or
    the whole map from the first stage that runs whole, and ``tiled``
    holds which stages of the last forward ran on tiles."""

    def __init__(self, embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                 window_size=7, mlp_ratio=4.0, drop_path_rate=0.2,
                 gelu_approx=False, dtype=None, spatial=None):
        super().__init__()
        self.dtype = dtype
        self.window_size = window_size
        self.spatial = spatial
        self.tiled = ()
        self._logged = set()
        self.patch_embed = PatchEmbed(embed_dim, dtype=dtype)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        layers, dim, idx = [], embed_dim, 0
        for i, depth in enumerate(depths):
            blocks = [SwinBlock(dim, num_heads[i], window_size,
                                0 if d % 2 == 0 else window_size // 2,
                                mlp_ratio, dpr[idx + d], gelu_approx, dtype)
                      for d in range(depth)]
            idx += depth
            last = i == len(depths) - 1
            layers.append(BasicLayer(
                blocks, None if last else PatchMerging(dim, dtype=dtype)))
            dim = dim if last else 2 * dim
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        x = self.patch_embed(to_dtype(x, self.dtype))
        outs, tiled = [], []
        on_tiles = self.spatial is not None
        for layer in self.layers:
            if on_tiles and not stage_on_tiles(x.shape[1], self.window_size,
                                               layer.downsample is not None):
                x = all_gather_h(x, self.spatial, site="swin_stage")
                on_tiles = False
            tile = StageTile(self.spatial, x.shape[1]) if on_tiles else None
            tiled.append(on_tiles)
            for block in layer.blocks:
                x = block(x, tile)
            outs.append(x)
            if layer.downsample is not None:
                x = layer.downsample(x)
        self.tiled = tuple(tiled)
        if self.spatial is not None and tuple(outs[0].shape[1:3]) not in self._logged:
            self._logged.add(tuple(outs[0].shape[1:3]))
            log.info("swin stages on H tiles of %d ranks (first stage %s rows "
                     "a tile): %s", self.spatial.size, outs[0].shape[1],
                     ["tile" if t else "whole" for t in self.tiled])
        return outs
