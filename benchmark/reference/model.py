"""The plain float32 NMRF reference: resnet or Swin-T backbone (with the
deformable neck), group-wise cost volume, DPN, Inference and Refinement
(NMRF-Stereo, CVPR 2024, arXiv:2403.11193; github.com/aeolusguan/NMRF).

A frozen copy of the measured package's plain path, one device, no
kernels, no checkpointing, every layer in float32, so that the two
compute one function; it imports nothing of that package.  Module names
are the upstream ``state_dict`` keys, which the measured package uses
too, so one ``state_dict`` loads into both.  Departures from the
published code, shared with the measured package: the proposal loss is
weighted (the upstream weights it under a key no loss has), and the swin
neck's deformable attention samples with ``grid_sample``.

``set_fp8(model)`` turns the model into the control of the benchmark's
output check, computed in float8, the precision below the bfloat16 that
the configurations state: every Linear and convolution rounds its input
and weight, and every attention its q, k and v, to float8 e4m3, and the
gradient reaching each of their outputs to float8 e5m2 (one scale a
tensor), so that the backward's products take float8 operands too."""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import ops

# largest finite float8 values: e4m3 for values, e5m2 for gradients
FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(x, dtype):
    """x rounded to ``dtype`` under one scale (its largest magnitude to
    the format's largest value)."""
    scale = FP8[dtype] / x.abs().amax().clamp(min=1e-12)
    return (x * scale).to(dtype).to(x.dtype) / scale


def fp8(x):
    """x rounded to float8 e4m3, with x's gradient."""
    return x + (_round(x.detach(), torch.float8_e4m3fn) - x).detach()


class _Fp8Grad(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to float8 e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def run_layer(layer, remat, *args):
    """One NMP layer; with ``remat`` its activations are recomputed in the
    backward pass (no drop-path lies in these layers)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(layer, *args, use_reentrant=False)
    return layer(*args)


class _Precision:
    """The control's switch: with ``self.fp8`` the inputs of a product are
    rounded to float8 e4m3 (``lowp``) and the gradient reaching its output
    to float8 e5m2 (``lowg``), so that the backward's products take
    float8 operands too."""

    fp8 = False

    def lowp(self, *xs):
        return tuple(fp8(x) for x in xs) if self.fp8 else xs

    def lowg(self, y):
        return _Fp8Grad.apply(y) if self.fp8 and y.requires_grad else y


def set_fp8(model, on=True):
    for m in model.modules():
        if isinstance(m, _Precision):
            m.fp8 = on
    return model


class Linear(nn.Linear, _Precision):
    def forward(self, x):
        x, w = self.lowp(x, self.weight)
        return self.lowg(F.linear(x, w, self.bias))


class Conv2d(nn.Conv2d, _Precision):
    """Convolution of channel-last [B, H, W, C]."""

    def forward(self, x):
        x, w = self.lowp(x.permute(0, 3, 1, 2), self.weight)
        return self.lowg(self._conv_forward(x, w, self.bias)).permute(
            0, 2, 3, 1)


class Conv1d(nn.Conv1d, _Precision):
    def forward(self, x):
        x, w = self.lowp(x, self.weight)
        return self.lowg(self._conv_forward(x, w, self.bias))


class DepthwiseConv(nn.Conv2d, _Precision):
    """The NCHW depthwise 3x3 of the CSWin positional term."""

    def forward(self, x):
        x, w = self.lowp(x, self.weight)
        return self.lowg(self._conv_forward(x, w, self.bias))


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim, eps=1e-5):
        super().__init__(dim, eps=eps)


class GELU(nn.Module):
    """Exact GELU, or its tanh form where the configuration deploys it."""

    def __init__(self, tanh=False):
        super().__init__()
        self.tanh = tanh

    def forward(self, x):
        return F.gelu(x, approximate="tanh" if self.tanh else "none")


def pool2(x):
    """2 x 2 average pool of [B, H, W, C]."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def instance_norm(x, eps=1e-5):
    """Affine-free instance norm of [B, H, W, C], single-pass moments."""
    n = x.shape[1] * x.shape[2]
    mean = x.sum(dim=(1, 2), keepdim=True) / n
    var = torch.clamp((x * x).sum(dim=(1, 2), keepdim=True) / n - mean * mean,
                      min=0.0)
    return (x - mean) * torch.rsqrt(var + eps)


class DropPath(nn.Module):
    """Stochastic depth per sample; in training the keep mask comes from
    the model's ``masks`` (:class:`DropPathMasks`)."""

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)
        self.masks = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = self.masks.draw(x.shape[0], keep)
        mask = mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
        return torch.where(mask, x / keep, 0.0)


class DropPathMasks:
    """Keep masks from one generator, drawn call by call in forward order:
    ``rand(batch) < keep`` on the generator's device."""

    def __init__(self, generator):
        self.generator = generator

    def draw(self, batch, keep):
        return torch.rand(batch, generator=self.generator,
                          device=self.generator.device) < keep


class Mlp(nn.Module):
    def __init__(self, dim, hidden, out, tanh=False):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.act = GELU(tanh)
        self.fc2 = Linear(hidden, out)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class MLPBlock(nn.Module):
    def __init__(self, in_dim, hidden, out, num_layers):
        super().__init__()
        dims_in = [in_dim] + [hidden] * (num_layers - 1)
        dims_out = [hidden] * (num_layers - 1) + [out]
        self.layers = nn.ModuleList(Linear(i, o)
                                    for i, o in zip(dims_in, dims_out))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class ConvINReluConv(nn.Module):
    """conv3x3 -> instance norm -> relu -> conv1x1, both without bias."""

    def __init__(self, cin, mid, cout):
        super().__init__()
        self.add_module("0", Conv2d(cin, mid, 3, padding=1, bias=False))
        self.add_module("3", Conv2d(mid, cout, 1, bias=False))

    def forward(self, x):
        return self._modules["3"](torch.relu(instance_norm(
            self._modules["0"](x))))


# --------------------------------------------------------------------------- #
# resnet backbone
# --------------------------------------------------------------------------- #

class ResidualBlock(nn.Module):
    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.downsample = None
        if not (stride == 1 and cin == planes):
            self.downsample = nn.Sequential(Conv2d(cin, planes, 1,
                                                   stride=stride))

    def forward(self, x):
        y = torch.relu(instance_norm(self.conv1(x)))
        y = torch.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return torch.relu(y + x)


class Backbone(nn.Module):
    """[B, H, W, 3] in 0..255 -> [1/4 [B, H/4, W/4, C], its 2x2 pool]."""

    def __init__(self, out=256):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64),
                                    ResidualBlock(64, 64))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2),
                                    ResidualBlock(96, 96))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128),
                                    ResidualBlock(128, 128))
        self.conv2 = Conv2d(128, out, 1)

    def forward(self, x):
        x = 2.0 * (x / 255.0) - 1.0
        x = torch.relu(instance_norm(self.conv1(x)))
        x = self.conv2(self.layer3(self.layer2(self.layer1(x))))
        return [x, pool2(x)]


# --------------------------------------------------------------------------- #
# Swin-T backbone and deformable neck
# --------------------------------------------------------------------------- #

def swin_shift_mask(Hp, Wp, ws, shift):
    """[nW, ws*ws, ws*ws]: -100 between tokens of different shifted regions."""
    img = np.zeros((Hp, Wp))
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in cuts:
        for wsl in cuts:
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(Hp // ws, ws, Wp // ws, ws).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, ws * ws)
    return np.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0).astype(
        np.float32)


class SwinWindowAttention(nn.Module, _Precision):
    def __init__(self, dim, ws, heads):
        super().__init__()
        self.ws, self.heads = ws, heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))

    def forward(self, x, mask):
        B_, N, C = x.shape
        h = self.heads
        hd = C // h
        qkv = self.qkv(x).reshape(B_, N, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = self.lowp(qkv[0] * hd ** -0.5, qkv[1], qkv[2])
        idx = torch.as_tensor(ops.relative_position_index(self.ws, self.ws)
                              .reshape(-1), device=x.device)
        bias = self.relative_position_bias_table[idx].reshape(N, N, h)
        attn = q @ k.transpose(-2, -1) + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, h, N, N)
                    + mask[None, :, None]).reshape(B_, h, N, N)
        out = (torch.softmax(attn, -1) @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(self.lowg(out))


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, ws, shift, drop_path, tanh):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = LayerNorm(dim)
        self.attn = SwinWindowAttention(dim, ws, heads)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim, dim, tanh)

    def forward(self, x):
        B, H, W, C = x.shape
        ws, s = self.ws, self.shift
        shortcut = x
        x = self.norm1(x)
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if s > 0:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
            mask = torch.as_tensor(swin_shift_mask(Hp, Wp, ws, s),
                                   device=x.device)
        xw = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(
            0, 1, 3, 2, 4, 5)
        a = self.attn(xw.reshape(-1, ws * ws, C), mask)
        x = a.reshape(B, Hp // ws, Wp // ws, ws, ws, C).permute(
            0, 1, 3, 2, 4, 5)
        x = x.reshape(B, Hp, Wp, C)
        if s > 0:
            x = torch.roll(x, (s, s), dims=(1, 2))
        x = shortcut + self.drop_path(x[:, :H, :W])
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.proj = Conv2d(3, dim, 4, stride=4)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        return self.norm(self.proj(x))


class BasicLayer(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """Swin-T: depths (2, 2, 6, 2), heads (3, 6, 12, 24), window 7;
    returns the four stage maps."""

    def __init__(self, drop_path_rate, tanh, embed=96, depths=(2, 2, 6, 2),
                 heads=(3, 6, 12, 24), ws=7):
        super().__init__()
        self.patch_embed = PatchEmbed(embed)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        layers, dim, i0 = [], embed, 0
        for i, depth in enumerate(depths):
            blocks = [SwinBlock(dim, heads[i], ws,
                                0 if d % 2 == 0 else ws // 2, dpr[i0 + d],
                                tanh) for d in range(depth)]
            i0 += depth
            last = i == len(depths) - 1
            layers.append(BasicLayer(blocks,
                                     None if last else PatchMerging(dim)))
            dim = dim if last else 2 * dim
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        x = self.patch_embed(x)
        outs = []
        for layer in self.layers:
            for block in layer.blocks:
                x = block(x)
            outs.append(x)
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs


NECK_EPS = 1e-6


class MSDeformAttn(nn.Module):
    def __init__(self, d_model, n_levels, n_heads, n_points, ratio):
        super().__init__()
        self.n_levels, self.n_heads = n_levels, n_heads
        self.n_points = n_points
        self.v_dim = int(d_model * ratio)
        self.value_proj = Linear(d_model, self.v_dim)
        self.sampling_offsets = Linear(d_model,
                                       n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = Linear(self.v_dim, d_model)

    def forward(self, query, reference_points, flat, spatial_shapes):
        B, Lq, _ = query.shape
        M, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(flat).reshape(B, flat.shape[1], M,
                                              self.v_dim // M)
        offsets = self.sampling_offsets(query).reshape(B, Lq, M, L, P, 2)
        weights = torch.softmax(self.attention_weights(query).reshape(
            B, Lq, M, L * P), dim=-1).reshape(B, Lq, M, L, P)
        norm = torch.tensor([[w, h] for h, w in spatial_shapes],
                            dtype=torch.float32, device=query.device)
        loc = reference_points[:, :, None, :, None, :] \
            + offsets / norm[None, None, None, :, None, :]
        return self.output_proj(ops.ms_deform_attn(value, spatial_shapes, loc,
                                                   weights))


class DWConv(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x):
        return self.dwconv(x)


class ConvFFN(nn.Module):
    def __init__(self, dim, hidden, tanh):
        super().__init__()
        self.hidden = hidden
        self.fc1 = Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.act = GELU(tanh)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x, H, W):
        B, N, _ = x.shape
        x = self.dwconv(self.fc1(x).reshape(B, H, W, self.hidden))
        return self.fc2(self.act(x.reshape(B, N, self.hidden)))


class Extractor(nn.Module):
    def __init__(self, dim, tanh, heads=8, points=4, ratio=0.5, cffn=0.25):
        super().__init__()
        self.query_norm = LayerNorm(dim, eps=NECK_EPS)
        self.feat_norm = LayerNorm(dim, eps=NECK_EPS)
        self.attn = MSDeformAttn(dim, 1, heads, points, ratio)
        self.ffn = ConvFFN(dim, int(dim * cffn), tanh)
        self.ffn_norm = LayerNorm(dim, eps=NECK_EPS)
        self.drop_path = DropPath(0.0)

    def forward(self, query, ref, feat, shapes, H, W):
        query = query + self.attn(self.query_norm(query), ref,
                                  self.feat_norm(feat), shapes)
        return query + self.drop_path(self.ffn(self.ffn_norm(query), H, W))


class ConvStem(nn.Module):
    def __init__(self, planes, out):
        super().__init__()
        self.stem = nn.ModuleDict({
            "0": Conv2d(3, planes, 3, stride=2, padding=1, bias=False),
            "3": Conv2d(planes, planes, 3, padding=1, bias=False),
            "6": Conv2d(planes, planes, 3, padding=1, bias=False)})
        self.fc = Conv2d(planes, out, 1)

    def forward(self, x):
        for conv in self.stem.values():
            x = torch.relu(instance_norm(conv(x)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        x = self.fc(x)
        B, H, W, C = x.shape
        return x.reshape(B, H * W, C)


def reference_points(H, W, device):
    ry, rx = np.meshgrid(np.linspace(0.5, H - 0.5, H) / H,
                         np.linspace(0.5, W - 0.5, W) / W, indexing="ij")
    pts = np.stack([rx.reshape(-1), ry.reshape(-1)], -1).astype(np.float32)
    return torch.as_tensor(pts, device=device)[None, :, None]


class DeformNeck(nn.Module):
    def __init__(self, dim, channels, tanh):
        super().__init__()
        self.dim = dim
        self.stem = ConvStem(64, dim)
        self.fcs = nn.ModuleList(nn.Sequential(LayerNorm(c, eps=NECK_EPS),
                                               Linear(c, dim))
                                 for c in channels)
        self.extractors = nn.ModuleList(Extractor(dim, tanh) for _ in channels)

    def forward(self, image, features):
        B, Hi, Wi, _ = image.shape
        H, W = Hi // 4, Wi // 4
        c = self.stem(image)
        ref = reference_points(H, W, image.device)
        for fc, extractor, feat in zip(self.fcs, self.extractors, features):
            fb, fh, fw, fch = feat.shape
            flat = fc(feat.reshape(fb, fh * fw, fch))
            c = extractor(c, ref, flat, [(fh, fw)], H, W)
        return c.reshape(B, H, W, self.dim)


IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


class SwinAdaptor(nn.Module):
    def __init__(self, out, drop_path, tanh):
        super().__init__()
        self.backbone = SwinTransformer(drop_path, tanh)
        self.neck = DeformNeck(out, [96, 192, 384, 768], tanh)

    def forward(self, x):
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        x = (x - mean) / std
        out = self.neck(x, self.backbone(x))
        return [out, pool2(out)]


# --------------------------------------------------------------------------- #
# NMP layers
# --------------------------------------------------------------------------- #

ABS_ENC = 31  # fourier_coord_embed of one coordinate, 15 bands


class BasicAttention(nn.Module, _Precision):
    """Self-edge attention over the N candidates of one pixel."""

    def __init__(self, dim, extra, heads):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.norm1 = LayerNorm(dim)
        self.q = Linear(dim + extra, dim)
        self.k = Linear(dim + extra, dim)
        self.v = Linear(dim, dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, enc):
        M, N, _ = x.shape
        h, hd = self.heads, self.dim // self.heads
        y = self.norm1(x)
        qk_in = torch.cat([y, enc], dim=-1)
        q, k, v = self.lowp(self.q(qk_in).reshape(M, N, h, hd),
                            self.k(qk_in).reshape(M, N, h, hd),
                            self.v(y).reshape(M, N, h, hd))
        attn = torch.softmax(
            torch.einsum("mihd,mjhd->mhij", q, k) * hd ** -0.5, dim=-1)
        out = torch.einsum("mhij,mjhd->mihd", attn, v).reshape(M, N, self.dim)
        return x + self.proj(self.lowg(out))


class WindowAttention(nn.Module, _Precision):
    """Shifted-window attention with the relative-position table of q-, k-
    and v-side terms; the roll of a shifted layer around it."""

    def __init__(self, dim, ws, heads, candidate_mask):
        super().__init__()
        self.ws, self.heads = ws, heads
        self.candidate_mask = candidate_mask
        self.relative_position_enc_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, 3 * dim))

    def forward(self, qkv, shift):
        if shift:
            qkv = torch.roll(qkv, (-shift, -shift), dims=(1, 2))
        (qkv,) = self.lowp(qkv)
        out = self.lowg(ops.window_attention(
            qkv, self.relative_position_enc_table, shift, (self.ws, self.ws),
            self.heads, self.candidate_mask))
        if shift:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        return out


class SwinNMP(nn.Module):
    def __init__(self, dim, heads, ws, ratio, tanh, candidate_mask):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.qkv = Linear(dim + ABS_ENC, 3 * dim)
        self.attn = WindowAttention(dim, ws, heads, candidate_mask)
        self.proj = Linear(dim, dim)
        self.mlp = Mlp(dim, int(dim * ratio), dim, tanh)

    def forward(self, x, enc, shift):
        y = torch.cat([self.norm1(x), enc], dim=-1)
        x = x + self.proj(self.attn(self.qkv(y), shift))
        return x + self.mlp(self.norm2(x))


class CSWinAttention(nn.Module, _Precision):
    """Vertical (idx 0) or horizontal (idx 1) stripes of width ``split``,
    with the depthwise 3x3 positional term summed over the candidate
    planes less the other candidates' centre taps."""

    def __init__(self, dim, idx, split, heads):
        super().__init__()
        self.dim, self.idx, self.split, self.heads = dim, idx, split, heads
        self.get_v = DepthwiseConv(dim, dim, 3, padding=1, groups=dim,
                                   bias=False)

    def forward(self, q, k, v):
        B, H, W, N, C = q.shape
        H_sp, W_sp = (H, self.split) if self.idx == 0 else (self.split, W)
        H_pad, W_pad = (H_sp - H % H_sp) % H_sp, (W_sp - W % W_sp) % W_sp
        tp, lp = H_pad // 2, W_pad // 2
        pad = (0, 0, 0, 0, lp, W_pad - lp, tp, H_pad - tp)
        q, k, v = (F.pad(t, pad) for t in (q, k, v))
        Hp, Wp = H + H_pad, W + W_pad
        ni, nj = Hp // H_sp, Wp // W_sp
        vs = v.reshape(B, ni, H_sp, nj, W_sp, N, C).permute(
            0, 1, 3, 5, 6, 2, 4)
        vs = vs.reshape(B * ni * nj * N, C, H_sp, W_sp)
        rpe = self.get_v(vs).reshape(B * ni * nj, N, C, H_sp, W_sp)
        center = vs.reshape(B * ni * nj, N, C, H_sp, W_sp) \
            * self.get_v.weight[:, 0, 1, 1][:, None, None]
        rpe = rpe.sum(1, keepdim=True) - (center.sum(1, keepdim=True) - center)
        rpe = rpe.reshape(B, ni, nj, N, C, H_sp, W_sp).permute(
            0, 1, 5, 2, 6, 3, 4)
        q, k, v = self.lowp(q, k, v)
        out = self.lowg(ops.stripe_attention(q, k, v, H_sp, W_sp, self.heads))
        out = out + rpe.reshape(B, Hp, Wp, N, C)
        return out[:, tp:tp + H, lp:lp + W]


class CSWinNMP(nn.Module):
    def __init__(self, dim, qk_dim, v_dim, heads, split, ratio, tanh):
        super().__init__()
        self.dim, self.v_dim = dim, v_dim
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.q = Linear(qk_dim, dim)
        self.k = Linear(qk_dim, dim)
        self.v = Linear(v_dim, dim)
        self.attns = nn.ModuleList(
            CSWinAttention(dim // 2, i, split, heads // 2) for i in range(2))
        self.proj = Linear(dim, dim)
        self.mlp = Mlp(dim, int(dim * ratio), dim, tanh)

    def forward(self, tgt, context):
        B, H, W, N, C = tgt.shape
        x = self.norm1(tgt)
        qk = torch.cat([x, context], dim=-1)
        v_in = x
        if self.v_dim > self.dim:
            pe = ops.fourier_grid_embed((H, W), self.v_dim - self.dim,
                                        device=x.device)
            v_in = torch.cat([x, pe[None, :, :, None].expand(
                B, H, W, N, self.v_dim - self.dim)], dim=-1)
        q, k, v = self.q(qk), self.k(qk), self.v(v_in)
        half = self.dim // 2
        msg = torch.cat([self.attns[0](q[..., :half], k[..., :half],
                                       v[..., :half]),
                         self.attns[1](q[..., half:], k[..., half:],
                                       v[..., half:])], dim=-1)
        x = tgt + self.proj(msg)
        return x + self.mlp(self.norm2(x))


class PropagationLayer(nn.Module):
    def __init__(self, dim, context_dim, split, heads, ratio, tanh):
        super().__init__()
        self.nmp = CSWinNMP(dim, dim + context_dim, dim, heads, split, ratio,
                            tanh)

    def forward(self, x, context):
        return self.nmp(x, context)


class Propagation(nn.Module):
    remat = False

    def __init__(self, dim, groups, layers, context_dim, split, heads, ratio,
                 tanh):
        super().__init__()
        self.dim = dim
        self.cost_encoder = nn.Sequential(Linear(groups * 9, dim), GELU(),
                                          Linear(dim, dim))
        self.proj = Linear(dim + ABS_ENC, dim, bias=False)
        self.layers = nn.ModuleList(PropagationLayer(dim, context_dim, split,
                                                     heads, ratio, tanh)
                                    for _ in range(layers))
        self.norm = LayerNorm(dim)

    def forward(self, cost, seeds, context):
        B, H, W, _ = context.shape
        N = seeds.shape[-1]
        cost_feat = self.cost_encoder(ops.sample_cost(cost, seeds))
        seeds_f = seeds.float()
        enc = ops.fourier_coord_embed(seeds_f[..., None], 15, 3.14 / 64)
        x = self.proj(torch.cat([cost_feat, enc], dim=-1)).reshape(
            B, H, W, N, self.dim)
        ctx = context[:, :, :, None].expand(B, H, W, N, context.shape[-1])
        for layer in self.layers:
            x = run_layer(layer, self.remat, x, ctx)
        return self.norm(x), seeds_f


class DPN(nn.Module):
    def __init__(self, groups, proposals, feat_dim, context_dim, layers, dim,
                 split, heads, ratio, tanh):
        super().__init__()
        self.proposals = proposals
        self.mlp = nn.Sequential(Conv1d(groups, 8, 5, padding=2), nn.ReLU(),
                                 Conv1d(8, 16, 5, padding=2), nn.ReLU(),
                                 Conv1d(16, 1, 5, padding=2))
        self.proj = ConvINReluConv(feat_dim, 128, context_dim)
        self.propagation = Propagation(dim, groups, layers, context_dim, split,
                                       heads, ratio, tanh)
        self.prop_head = MLPBlock(dim, dim, 1, 3)

    def forward(self, cost_volume, fmap1, seeds=None):
        """-> (prob [M, D], seeds [M, N], labels [M, N]); the NMS picks
        the seeds from prob, unless ``seeds`` (integer, [M, N]) are
        given."""
        B, H, W, G, D = cost_volume.shape
        flat = cost_volume.reshape(B * H * W, G, D)
        prob = torch.softmax(self.mlp(flat).squeeze(1), dim=-1)
        if seeds is None or seeds.shape != (B * H * W, self.proposals):
            seeds = ops.nms_topk_seeds(prob, self.proposals)
        seeds = seeds.long()
        memory, seeds_f = self.propagation(flat, seeds, self.proj(fmap1))
        offsets = self.prop_head(memory).reshape(B * H * W, self.proposals)
        return prob, seeds, torch.relu(offsets + seeds_f)


class InferenceLayer(nn.Module):
    def __init__(self, dim, ws, heads, ratio, tanh):
        super().__init__()
        self.self_nmp = BasicAttention(dim, ABS_ENC, heads)
        self.nmp = SwinNMP(dim, heads, ws, ratio, tanh, candidate_mask=True)

    def forward(self, x, enc, shift):
        B, H, W, N, C = x.shape
        y = self.self_nmp(x.reshape(B * H * W, N, C),
                          enc.reshape(B * H * W, N, -1))
        return self.nmp(y.reshape(B, H, W, N, C), enc, shift)


class RefinementLayer(nn.Module):
    def __init__(self, dim, ws, heads, ratio, tanh):
        super().__init__()
        self.nmp = SwinNMP(dim, heads, ws, ratio, tanh, candidate_mask=False)

    def forward(self, x, enc, shift):
        return self.nmp(x, enc, shift)


class _NMPStage(nn.Module):
    remat = False
    layer_cls = None
    normalizer = None

    def __init__(self, groups, dim, layers, ws, heads, ratio, tanh,
                 feat_dim=64):
        super().__init__()
        self.groups, self.ws = groups, ws
        self.ffn = Mlp(2 * feat_dim + groups, dim, dim, tanh)
        self.layers = nn.ModuleList(self.layer_cls(dim, ws, heads, ratio, tanh)
                                    for _ in range(layers))
        self.norm = LayerNorm(dim)

    def forward(self, labels, f1, f2, f1_gw, f2_gw):
        """labels [B, H, W, N] -> every layer's normed output
        [L, B, H, W, N, C]."""
        B, H, W, N = labels.shape
        G = self.groups
        warped_gw = ops.disp_warp(f2_gw, labels)
        c = f1_gw.shape[-1] // G
        corr = (f1_gw.reshape(B, H, W, 1, G, c)
                * warped_gw.reshape(B, H, W, N, G, c)).mean(-1)
        feat = torch.cat([f1[:, :, :, None].expand(B, H, W, N, f1.shape[-1]),
                          ops.disp_warp(f2, labels), corr], dim=-1)
        x = self.ffn(feat)
        enc = ops.fourier_coord_embed(labels[..., None], 15, self.normalizer)
        ws = self.ws
        H_pad, W_pad = (ws - H % ws) % ws, (ws - W % ws) % ws
        tp, lp = H_pad // 2, W_pad // 2
        pad = (0, 0, 0, 0, lp, W_pad - lp, tp, H_pad - tp)
        x, enc = F.pad(x, pad), F.pad(enc, pad)
        ys = []
        for i, layer in enumerate(self.layers):
            x = run_layer(layer, self.remat, x, enc,
                          0 if i % 2 == 0 else ws // 2)
            ys.append(x)
        return self.norm(torch.stack(ys)[:, :, tp:tp + H, lp:lp + W])


class Inference(_NMPStage):
    layer_cls = InferenceLayer
    normalizer = 3.14 / 64


class Refinement(_NMPStage):
    layer_cls = RefinementLayer
    normalizer = 3.14 / 128


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #

def subpatch_to_full(x, patch):
    """[L, B, H, W, N, patch^2] -> [L, B, H patch, W patch, N]."""
    L, B, H, W, N, _ = x.shape
    x = x.reshape(L, B, H, W, N, patch, patch).permute(0, 1, 2, 5, 3, 6, 4)
    return x.reshape(L, B, H * patch, W * patch, N)


def blocks(x, k):
    """[B, H, W] -> [B, H/k, W/k, k k], each k x k block's values."""
    B, H, W = x.shape
    v = x.reshape(B, H // k, k, W // k, k).permute(0, 1, 3, 2, 4)
    return v.reshape(B, H // k, W // k, k * k)


def full_candidates(labels, head):
    """The candidates of every full-size pixel, [B, H, W, N]: labels [B,
    h, w, N] plus head [B, h, w, N, 64], 8 x 8 sub-pixels a cell."""
    return subpatch_to_full(torch.relu(labels[None, ..., None] + head[None]),
                            8)[0]


def pick(candidates, score):
    """The Refinement's two integer choices: each full-size pixel's
    candidate of the largest score ([B, H, W]), and the position in each 4
    x 4 block of the lower median of the chosen candidates ([B, H/4,
    W/4])."""
    idx = torch.argmax(subpatch_to_full(score[None], 8)[0], dim=-1)
    chosen = torch.gather(candidates, -1, idx[..., None]).squeeze(-1)
    order = torch.argsort(blocks(chosen, 4), dim=-1, stable=True)
    return idx, order[..., 7]


def choices(out):
    """A forward's integer choices on the host, as ``NMRF.forward``'s
    ``force`` takes them, made by this module's code from the forward's
    outputs (``prob``, ``proposal``, ``heads``): ``seeds`` [B h w, N],
    the NMS's picks from ``prob``; ``argmax`` [B, H, W] and ``median``
    [B, H/4, W/4], :func:`pick`'s."""
    head, score = (t.detach().float() for t in out["heads"])
    B, h, w, N, _ = head.shape
    labels = out["proposal"].detach().float().reshape(B, h, w, N)
    idx, med = pick(full_candidates(labels, head), score)
    return {"seeds": ops.nms_topk_seeds(out["prob"].detach().float(),
                                        N).cpu(),
            "argmax": idx.to(torch.uint8).cpu(),
            "median": med.to(torch.uint8).cpu()}


# the configuration keys the reference reads, and those it holds fixed
SUPPORTED = {"NMP.NORMALIZE_BEFORE": True, "NMP.WITH_REFINEMENT": True,
             "SOLVER.AUX_LOSS": True, "NMP.RETURN_INTERMEDIATE": True}


class NMRF(nn.Module):
    """``spec``: a configuration's keys (``benchmark/configs/*.json``, the
    measured package's config names: ``BACKBONE.MODEL_TYPE``,
    ``NMP.WINDOW_SIZE``, ...).  forward(img1, img2) on [B, H, W, 3]
    (0..255, H and W multiples of ``DATASETS.DIVIS_BY``) returns the dict
    ``disp`` [B, H, W], ``prob`` [B h w, D], ``proposal`` and
    ``initial_proposal`` [B, h w, N], ``disp_pred`` [B, H, W],
    ``coarse_disp_layers``/``logits_layers`` [L, B, H, W, N] and
    ``disp_pred_layers`` [L, B, H, W] (L the stage's layers in training, 1
    in eval mode); ``features`` (the 1/8 features of both images,
    [2B, h, w, C]), ``inference`` and ``refinement`` (the stages' last
    normed outputs) and ``heads`` (see ``forward``) for the output
    check."""

    def __init__(self, spec):
        super().__init__()
        for key, value in SUPPORTED.items():
            if spec.get(key, value) != value:
                raise ValueError(f"the reference computes {key} = {value} "
                                 f"only, not {spec[key]}")
        tanh = bool(spec.get("TPU.GELU_APPROX", False))
        out = spec["BACKBONE.OUT_CHANNELS"]
        ratio = spec["NMP.MLP_RATIO"]
        heads = spec["NMP.INFER_N_HEADS"]
        dim = spec["NMP.INFER_EMBED_DIM"]
        self.proposals = spec["DPN.NUM_PROPOSALS"]
        self.max_disp = spec["DPN.MAX_DISP"]
        self.groups = spec["DPN.COST_GROUP"]
        self.divis_by = spec["DATASETS.DIVIS_BY"]
        if spec["BACKBONE.MODEL_TYPE"] == "resnet":
            self.backbone = Backbone(out)
        else:
            self.backbone = SwinAdaptor(out, spec["BACKBONE.DROP_PATH"], tanh)
        self.concatconv = ConvINReluConv(out, 128, 64)
        self.gw = ConvINReluConv(out, 128, 256)
        self.dpn = DPN(self.groups, self.proposals, out,
                       spec["DPN.CONTEXT_DIM"], spec["NMP.NUM_PROP_LAYERS"],
                       spec["NMP.PROP_EMBED_DIM"], spec["NMP.SPLIT_SIZE"],
                       spec["NMP.PROP_N_HEADS"], ratio, tanh)
        self.inference = Inference(32, dim, spec["NMP.NUM_INFER_LAYERS"],
                                   spec["NMP.WINDOW_SIZE"], heads, ratio, tanh)
        self.infer_head = MLPBlock(dim, dim, 64, 3)
        self.infer_score_head = Linear(dim, 64)
        self.refinement = Refinement(32, dim, spec["NMP.NUM_REFINE_LAYERS"],
                                     spec["NMP.REFINE_WINDOW_SIZE"], heads,
                                     ratio, tanh)
        self.refine_head = MLPBlock(dim, dim, 16, 3)

    def set_remat(self, on=True):
        """Recompute each propagation, Inference and Refinement layer in
        the backward pass (the same values, less memory)."""
        for stage in (self.dpn.propagation, self.inference, self.refinement):
            stage.remat = on
        return self

    def set_drop_path_masks(self, masks):
        for m in self.modules():
            if isinstance(m, DropPath):
                m.masks = masks

    def forward(self, img1, img2, force=None):
        """The outputs of the class docstring.  ``force`` takes the
        integer choices of another run of the model (the judged program),
        as :func:`choices` makes them: the NMS's ``seeds``, and the
        ``argmax`` and ``median`` positions that pick the Refinement's
        input; every value stays this model's own.  A forced choice of
        another shape is not taken."""
        force = force or {}
        B = img1.shape[0]
        f = self.backbone(torch.cat([img1, img2], dim=0))
        f4, f8 = f[0], f[1]
        cost = ops.correlation_volume(f8[:B], f8[B:], self.max_disp // 8,
                                      self.groups)
        prob, seeds, labels = self.dpn(cost, f8[:B], force.get("seeds"))
        fm1, fm2 = self.concatconv(f8[:B]), self.concatconv(f8[B:])
        gw1, gw2 = self.gw(f8[:B]), self.gw(f8[B:])
        h8, w8 = fm1.shape[1:3]
        labels_curr = labels.reshape(B, h8, w8, self.proposals).detach()
        # in eval mode the heads read the last layer only, as served
        last = slice(None) if self.training else slice(-1, None)
        tgt = self.inference(labels_curr, fm1, fm2, gw1, gw2)[last]
        head, score = self.infer_head(tgt), self.infer_score_head(tgt)
        coarse = subpatch_to_full(torch.relu(labels_curr[None, ..., None]
                                             + head), 8)
        logits = subpatch_to_full(0.25 * score, 8)
        disp_curr = self.select(labels_curr, head[-1], score[-1], force)
        rf1, rf2 = self.concatconv(f4[:B]), self.concatconv(f4[B:])
        rg1, rg2 = self.gw(f4[:B]), self.gw(f4[B:])
        tgt_r = self.refinement(disp_curr[..., None], rf1, rf2, rg1,
                                rg2)[last].squeeze(-2)
        disp_pred = torch.relu(disp_curr[None, ..., None]
                               + self.refine_head(tgt_r))
        disp_pred = subpatch_to_full(disp_pred[..., None, :], 4).squeeze(-1)
        return {
            "disp": disp_pred[-1] * 4,
            "disp_pred": disp_pred[-1],
            "prob": prob,
            "proposal": labels.reshape(B, -1, self.proposals),
            "initial_proposal": seeds.reshape(B, -1, self.proposals),
            "coarse_disp_layers": coarse,
            "logits_layers": logits,
            "disp_pred_layers": disp_pred,
            "features": f8,
            "inference": tgt[-1],
            "refinement": tgt_r[-1],
            "heads": (head[-1], score[-1]),
        }

    @staticmethod
    def select(labels, head, score, force):
        """The Refinement's input [B, H/4, W/4]: each pixel's candidate of
        the largest score, doubled, then the 4 x 4 lower median; at the
        forced ``argmax`` and ``median`` positions where given."""
        candidates = full_candidates(labels, head)
        if "argmax" in force and force["argmax"].shape == \
                candidates.shape[:-1]:
            idx, med = force["argmax"].long(), force["median"].long()
        else:
            idx, med = pick(candidates, score)
        chosen = torch.gather(candidates, -1, idx[..., None]).squeeze(-1)
        return torch.gather(blocks(chosen * 2, 4), -1,
                            med[..., None]).squeeze(-1).detach()
