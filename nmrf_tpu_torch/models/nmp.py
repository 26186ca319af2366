"""Neural message passing layers (``nmrf_tpu/models/nmp.py``; reference
``nmrf/models/NMP.py``).

Tokens are kept in spatial layout [B, H, W, N, C] (N = candidates), and
qkv channels in (component, head, hd) order, as in the JAX package.  With
``use_kernels`` the window and stripe attention go through the kernel
wrappers of ``ops/attention.py`` (the hand-written CUDA kernels for CUDA
tensors); otherwise they run those kernels' plain PyTorch versions.  On
the kernel path ``NMRF_FUSED_POS=1`` in the environment, read at each call
as the JAX package reads it (``nmp.py:282``), gives the window attention
the fully fused backward B7 instead of K1b.
"""

import os
from functools import lru_cache

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (
    masked_attention,
    masked_attention_plain,
    stripe_attention,
    stripe_attention_plain,
    stripe_mask,
    window_attention,
    window_attention_plain,
)
from ..ops.encodings import fourier_grid_embed
from ..parallel.spatial import all_gather_h, global_fourier_rows, global_roll_h
from .layers import GELU, LayerNorm, Linear, Mlp


@lru_cache(maxsize=16)
def tile_stripe_mask(T, N, index, Rq, device):
    """[1, Rq, T] rows ``index * Rq ..`` of the global anti-same-pixel mask of
    a T-token stripe, on ``device``: one host-to-device copy per shape, not
    one per layer call.  Made outside inference mode, so that a training
    step may save it for backward after a request has cached it."""
    with torch.inference_mode(False):
        return torch.as_tensor(stripe_mask(T, N)[index * Rq:(index + 1) * Rq],
                               device=device)[None]


class BasicAttention(nn.Module):
    """Self-edge attention over the N candidates of one pixel
    (reference ``BasicAttention``, ``NMP.py:70-139``)."""

    def __init__(self, dim, qk_extra_dim, num_heads=8, normalize_before=False,
                 dtype=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.normalize_before = normalize_before
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.q = Linear(dim + qk_extra_dim, dim, dtype=dtype)
        self.k = Linear(dim + qk_extra_dim, dim, dtype=dtype)
        self.v = Linear(dim, dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, label_rep, abs_encoding):
        """label_rep: [M, N, C]; abs_encoding: [M, N, C']."""
        h = self.num_heads
        hd = self.dim // h
        shortcut = label_rep
        x = self.norm1(label_rep) if self.normalize_before else label_rep
        if self.dtype is not None:
            abs_encoding = abs_encoding.to(self.dtype)
        qk_in = torch.cat([x.to(abs_encoding.dtype), abs_encoding], dim=-1)
        q, k, v = self.q(qk_in), self.k(qk_in), self.v(x)
        M, N = x.shape[:2]
        qh = q.reshape(M, N, h, hd).float()
        kh = k.reshape(M, N, h, hd).float()
        attn = torch.softmax(torch.einsum("mihd,mjhd->mhij", qh, kh) * hd ** -0.5,
                             dim=-1)
        out = torch.einsum("mhij,mjhd->mihd", attn.to(v.dtype),
                           v.reshape(M, N, h, hd)).reshape(M, N, self.dim)
        x = shortcut + self.proj(out)
        if not self.normalize_before:
            x = self.norm1(x)
            if self.dtype is not None:
                x = x.to(self.dtype)
        return x


class WindowAttention(nn.Module):
    """Windowed attention with a learnable relative-position table of width
    3*dim contributing q/k/v positional terms (reference
    ``WindowAttention``, ``NMP.py:142-292``; ``nmp.py:161``).

    With a spatial group (the input is an H tile of the image) the H roll
    of a shifted layer is the ring exchange of ``global_roll_h`` and the W
    roll stays local; the shifted-region mask takes global rows (row0 =
    tile index x tile height, hp_total = the global padded height,
    ``nmp.py:203-216,294-304,323-331``).  On the kernel path the backward
    is B7 when ``NMRF_FUSED_POS`` is set to anything but 0 (``nmp.py:282``);
    the plain path ignores it, as the JAX XLA path does."""

    def __init__(self, dim, window_size, num_heads, candidate_mask,
                 use_kernels=False, spatial=None):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = tuple(window_size)
        self.candidate_mask = candidate_mask
        self.use_kernels = use_kernels
        self.spatial = spatial
        wh, ww = self.window_size
        self.relative_position_enc_table = nn.Parameter(
            torch.zeros((2 * wh - 1) * (2 * ww - 1), 3 * dim))

    def forward(self, qkv, shift):
        """qkv: [B, Hp, Wp, N, 3C] (window-padded) -> [B, Hp, Wp, N, C].
        ``shift`` > 0 rolls the input by -shift (sign of ``jnp.roll``) and
        the output back by +shift."""
        sp = self.spatial
        if shift:
            if sp is None:
                qkv = torch.roll(qkv, (-shift, -shift), dims=(1, 2))
            else:
                qkv = torch.roll(global_roll_h(qkv, -shift, sp), -shift, dims=2)
        H = qkv.shape[1]
        row0, hp_total = (0, None) if sp is None else (sp.index * H, sp.size * H)
        args = (qkv.contiguous(), self.relative_position_enc_table, shift,
                self.window_size, self.num_heads, self.candidate_mask, row0,
                hp_total)
        if self.use_kernels:
            out = window_attention(*args, fused_pos=os.environ.get(
                "NMRF_FUSED_POS", "0") != "0")
        else:
            out = window_attention_plain(*args)
        if shift:
            if sp is None:
                out = torch.roll(out, (shift, shift), dims=(1, 2))
            else:
                out = global_roll_h(torch.roll(out, shift, dims=2), shift, sp)
        return out


class SwinNMP(nn.Module):
    """Swin message-passing block (reference ``SwinNMP``, ``NMP.py:295-398``)."""

    def __init__(self, dim, qk_extra_dim, num_heads, window_size, mlp_ratio=4.0,
                 gelu_approx=False, normalize_before=False, candidate_mask=False,
                 use_kernels=False, dtype=None, spatial=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.qkv = Linear(dim + qk_extra_dim, 3 * dim, dtype=dtype)
        self.attn = WindowAttention(dim, (window_size, window_size), num_heads,
                                    candidate_mask, use_kernels=use_kernels,
                                    spatial=spatial)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim,
                       act=GELU(gelu_approx), dtype=dtype)

    def forward(self, label_rep, abs_encoding, shift):
        """label_rep: [B, H, W, N, C]; abs_encoding: [B, H, W, N, C']."""
        return self.attn_output(label_rep, self.attn(
            self.attn_input(label_rep, abs_encoding), shift))

    def attn_input(self, label_rep, abs_encoding):
        """The window attention's input: qkv [B, H, W, N, 3C]."""
        x = self.norm1(label_rep) if self.normalize_before else label_rep
        if self.dtype is not None:
            abs_encoding = abs_encoding.to(self.dtype)
        x = torch.cat([x.to(abs_encoding.dtype), abs_encoding], dim=-1)
        return self.qkv(x)

    def attn_output(self, label_rep, attended):
        """The block's output from its input and the window attention's."""
        x = label_rep + self.proj(attended)
        if self.normalize_before:
            return x + self.mlp(self.norm2(x))
        x = self.norm1(x)
        x = self.norm2(x + self.mlp(x))
        return x.to(self.dtype) if self.dtype is not None else x


class CSWinAttention(nn.Module):
    """Cross-shaped-window stripe attention with a depthwise 3x3 positional
    term (reference ``CSWinAttention``, ``NMP.py:401-505``).

    idx=0: vertical stripes (H_sp = H, W_sp = split); idx=1: horizontal.
    The positional term sums the candidate planes and removes the other
    candidates' center-tap contributions (self-edge removal); it stays in
    PyTorch on both paths, as it stayed in XLA.  With a spatial group the
    vertical stripes span the global H (:meth:`_vertical_sharded`); the
    horizontal ones are tile-local.
    """

    def __init__(self, dim, idx, split_size=7, num_heads=8, use_kernels=False,
                 spatial=None):
        super().__init__()
        self.dim, self.idx = dim, idx
        self.split_size, self.num_heads = split_size, num_heads
        self.use_kernels = use_kernels
        self.spatial = spatial
        # depthwise conv weight [dim, 1, 3, 3] (reference ``get_v``)
        self.get_v = nn.Conv2d(dim, dim, 3, padding=1, groups=dim, bias=False)

    def forward(self, query, key, value):
        """query/key/value: [B, H, W, N, C] -> [B, H, W, N, C]."""
        B, H, W, N, C = query.shape
        if self.idx == 0 and self.spatial is not None:
            return self._vertical_sharded(query, key, value)
        if self.idx == 0:
            H_sp, W_sp = H, self.split_size
        else:
            H_sp, W_sp = self.split_size, W
            # under H-sharding horizontal stripes must not cross tiles
            assert self.spatial is None or H % H_sp == 0, (H, H_sp)
        # centered padding to stripe multiples (reference NMP.py:474-485)
        H_pad = (H_sp - H % H_sp) % H_sp
        W_pad = (W_sp - W % W_sp) % W_sp
        tp, lp = H_pad // 2, W_pad // 2
        pad = (0, 0, 0, 0, lp, W_pad - lp, tp, H_pad - tp)
        q, k, v = (F.pad(t, pad).contiguous() for t in (query, key, value))
        Hp, Wp = H + H_pad, W + W_pad
        ni, nj = Hp // H_sp, Wp // W_sp

        # depthwise 3x3 positional term on stripe-local candidate planes, in
        # v's dtype (the compute dtype)
        vs = v.reshape(B, ni, H_sp, nj, W_sp, N, self.dim)
        vs = vs.permute(0, 1, 3, 5, 6, 2, 4).reshape(B * ni * nj * N, self.dim,
                                                      H_sp, W_sp)
        rpe = self._positional(vs, B * ni * nj, N)
        rpe = rpe.reshape(B, ni, nj, N, self.dim, H_sp, W_sp)
        rpe = rpe.permute(0, 1, 5, 2, 6, 3, 4).reshape(B, Hp, Wp, N, self.dim)

        attend = stripe_attention if self.use_kernels else stripe_attention_plain
        out = attend(q, k, v, H_sp, W_sp, self.num_heads)
        out = out + rpe.to(out.dtype)
        return out[:, tp:tp + H, lp:lp + W]

    def _positional(self, vs, G, N):
        """Depthwise 3x3 term of stripe planes vs [G*N, dim, Hs, Ws], summed
        over the N candidates minus the other candidates' center taps ->
        [G, N, dim, Hs, Ws]."""
        weight = self.get_v.weight.to(vs.dtype)
        rpe = F.conv2d(vs, weight, padding=1, groups=self.dim)
        rpe = rpe.reshape(G, N, *rpe.shape[1:])
        center = vs.reshape(G, N, *vs.shape[1:]) \
            * weight[:, 0, 1, 1][:, None, None]
        return rpe.sum(1, keepdim=True) - (center.sum(1, keepdim=True) - center)

    def _vertical_sharded(self, query, key, value):
        """Vertical stripes spanning the GLOBAL H under H-sharding
        (``nmp.py:590-685``): the local query rows attend to the
        all-gathered stripe (B6, Rq = H_loc W_sp N, Rk = H W_sp N) under the
        tile's rows of the global anti-same-pixel mask; the depthwise
        positional term is computed on the gathered column and the tile's
        rows are sliced out, so taps across tile edges are exact."""
        sp = self.spatial
        B, H, W, N, C = query.shape  # H: the tile height
        h = self.num_heads
        hd = self.dim // h
        W_sp = self.split_size
        Hg = H * sp.size
        W_pad = (W_sp - W % W_sp) % W_sp
        lp = W_pad // 2
        pad = (0, 0, 0, 0, lp, W_pad - lp)
        q = F.pad(query, pad)
        kf = all_gather_h(F.pad(key, pad), sp)
        vf = all_gather_h(F.pad(value, pad), sp)
        Wp = W + W_pad
        nj = Wp // W_sp

        def heads_first(t, Hs):  # [B, Hs, Wp, N, C] -> [h, B*nj, Hs*W_sp*N, hd]
            t = t.reshape(B, Hs, nj, W_sp, N, h, hd)
            return t.permute(5, 0, 2, 1, 3, 4, 6).reshape(
                h, B * nj, Hs * W_sp * N, hd).contiguous()

        vs = vf.reshape(B, Hg, nj, W_sp, N, self.dim)
        vs = vs.permute(0, 2, 4, 5, 1, 3).reshape(B * nj * N, self.dim, Hg, W_sp)
        rpe = self._positional(vs, B * nj, N)[..., sp.index * H:(sp.index + 1) * H, :]
        rpe = rpe.permute(0, 3, 4, 1, 2).reshape(B * nj, H * W_sp * N, h, hd)

        mask = tile_stripe_mask(Hg * W_sp * N, N, sp.index, H * W_sp * N, q.device)
        attend = masked_attention if self.use_kernels else masked_attention_plain
        out = attend(heads_first(q, H), heads_first(kf, Hg), heads_first(vf, Hg),
                     mask, hd ** -0.5)
        out = out.permute(1, 2, 0, 3) + rpe.to(out.dtype)  # [B*nj, Rq, h, hd]
        out = out.reshape(B, nj, H, W_sp, N, self.dim).permute(0, 2, 1, 3, 4, 5)
        return out.reshape(B, H, Wp, N, self.dim)[:, :, lp:lp + W]


class CSWinNMP(nn.Module):
    """CSWin message-passing block (reference ``CSWinNMP``, ``NMP.py:508-600``).

    dim is split in half: one half attends in vertical stripes, the other in
    horizontal stripes.  qk input is (embedding ++ context); v gets a Fourier
    grid pos-embed when v_dim > dim.
    """

    def __init__(self, dim, qk_dim, v_dim, num_heads, split_size=7,
                 mlp_ratio=4.0, gelu_approx=False, normalize_before=False,
                 use_kernels=False, dtype=None, spatial=None):
        super().__init__()
        self.dim, self.v_dim = dim, v_dim
        self.spatial = spatial
        self.normalize_before = normalize_before
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.q = Linear(qk_dim, dim, dtype=dtype)
        self.k = Linear(qk_dim, dim, dtype=dtype)
        self.v = Linear(v_dim, dim, dtype=dtype)
        half = dim // 2
        self.attns = nn.ModuleList(
            CSWinAttention(half, idx=i, split_size=split_size,
                           num_heads=num_heads // 2, use_kernels=use_kernels,
                           spatial=spatial)
            for i in range(2))
        self.proj = Linear(dim, dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, act=GELU(gelu_approx),
                       dtype=dtype)

    def forward(self, tgt, context):
        """tgt: [B, H, W, N, C]; context: [B, H, W, N, C_ctx] or None."""
        B, H, W, N, C = tgt.shape
        shortcut = tgt
        x = self.norm1(tgt) if self.normalize_before else tgt
        if self.dtype is not None:
            x = x.to(self.dtype)
            if context is not None:
                context = context.to(self.dtype)
        qk = torch.cat([x, context], dim=-1) if context is not None else x
        if self.v_dim > self.dim and self.spatial is not None:
            # the embedding indexes GLOBAL rows: this tile's rows of the
            # global grid (nmp.py:737-750)
            pe = global_fourier_rows(fourier_grid_embed(
                (H * self.spatial.size, W), self.v_dim - self.dim,
                dtype=x.dtype, device=x.device), H, self.spatial)
        elif self.v_dim > self.dim:
            pe = fourier_grid_embed((H, W), self.v_dim - self.dim,
                                    dtype=x.dtype, device=x.device)
            pe = pe[None, :, :, None, :].expand(B, H, W, N, self.v_dim - self.dim)
            v_in = torch.cat([x, pe], dim=-1)
        else:
            v_in = x
        query, key, value = self.q(qk), self.k(qk), self.v(v_in)
        half = self.dim // 2
        x1 = self.attns[0](query[..., :half], key[..., :half], value[..., :half])
        x2 = self.attns[1](query[..., half:], key[..., half:], value[..., half:])
        msg = self.proj(torch.cat([x1, x2], dim=-1))
        x = shortcut + msg
        if self.normalize_before:
            return x + self.mlp(self.norm2(x))
        x = self.norm1(x)
        x = self.norm2(x + self.mlp(x))
        return x.to(self.dtype) if self.dtype is not None else x

