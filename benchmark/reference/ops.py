"""Plain float32 operations of the NMRF reference: the cost volume, the
DPN's NMS, warping and cost sampling, the Fourier encodings, the window
and stripe attention of the NMP layers, the soft histogram of the
criterion and the exact multi-scale deformable attention.  Each follows
the published model (NMRF-Stereo, CVPR 2024, arXiv:2403.11193, and its
code at github.com/aeolusguan/NMRF) and is a frozen copy of the
measured package's plain versions, so that the two compute one function;
nothing here imports that package.  Channel-last layouts throughout."""

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e9  # finite -inf stand-in, softmax-safe


# --------------------------------------------------------------------------- #
# cost volume, NMS, sampling, encodings
# --------------------------------------------------------------------------- #

def correlation_volume(f1, f2, max_disp, num_groups):
    """out[b, h, w, g, d] = mean_c f1[b, h, w, g, c] * f2[b, h, w - d, g, c],
    zero where w < d.  [B, H, W, C] -> [B, H, W, G, D]."""
    B, H, W, C = f1.shape
    c = C // num_groups
    a = f1.reshape(B, H, W, num_groups, c)
    b = f2.reshape(B, H, W, num_groups, c)
    full = torch.einsum("bhwgc,bhvgc->bhgwv", a, b) / c
    src = (torch.arange(W, device=f1.device)[:, None]
           - torch.arange(max_disp, device=f1.device)[None, :])
    valid = src >= 0
    idx = src.clamp(0, W - 1).expand(B, H, num_groups, W, max_disp)
    band = torch.where(valid, torch.gather(full, -1, idx),
                       torch.zeros((), device=f1.device))
    return band.permute(0, 1, 3, 2, 4)


def nms_topk_seeds(prob, k, eps=1e-3):
    """3-tap non-maximum suppression of [..., D] probabilities, then the k
    largest indices, ties to the lower index (a stable descending sort)."""
    xp = F.pad(prob, (1, 1), value=float("-inf"))
    pooled = torch.maximum(torch.maximum(xp[..., :-2], xp[..., 1:-1]),
                           xp[..., 2:])
    suppress = (prob != pooled) & (prob > eps)
    prob_ = torch.where(suppress, torch.full_like(prob, eps), prob)
    return torch.argsort(prob_, dim=-1, descending=True, stable=True)[..., :k]


def disp_warp(fmap, disp):
    """fmap [B, H, W, C] sampled at x = w - disp[..., n] (bilinear in x,
    zero outside the row) -> [B, H, W, N, C]."""
    B, H, W, C = fmap.shape
    N = disp.shape[-1]
    xs = torch.arange(W, dtype=disp.dtype, device=disp.device)[None, None, :,
                                                               None]
    x = (xs - disp).reshape(B, H, W * N)
    x0 = torch.floor(x)
    frac = x - x0
    x0i = x0.long()
    x1i = x0i + 1
    in0 = (x0i >= 0) & (x0i <= W - 1)
    in1 = (x1i >= 0) & (x1i <= W - 1)

    def gather(idx):
        idx = idx.clamp(0, W - 1)[..., None].expand(-1, -1, -1, C)
        return torch.gather(fmap, 2, idx)

    out = gather(x0i) * ((1.0 - frac) * in0)[..., None] \
        + gather(x1i) * (frac * in1)[..., None]
    return out.reshape(B, H, W, N, C)


def sample_cost(cost_volume, label_seed, radius=4):
    """[M, G, D] costs at seed + [-radius, radius] (clamped) of [M, N]
    integer seeds -> [M, N, G * (2 radius + 1)], group-major."""
    M, G, D = cost_volume.shape
    N = label_seed.shape[1]
    taps = 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, device=label_seed.device)
    idx = (label_seed.long()[:, :, None] + offs).clamp(0, D - 1)
    idx = idx.reshape(M, 1, N * taps).expand(M, G, N * taps)
    out = torch.gather(cost_volume, 2, idx).reshape(M, G, N, taps)
    return out.permute(0, 2, 1, 3).reshape(M, N, G * taps)


def fourier_coord_embed(coord, n_freqs, normalizer):
    """[..., D] -> [..., D (2 n_freqs + 1)]: per coordinate x = coord *
    normalizer, [sin(2^i x)..., cos(2^i x)..., x]."""
    bands = 2.0 ** torch.linspace(0.0, n_freqs - 1, n_freqs,
                                  dtype=coord.dtype, device=coord.device)
    scaled = coord[..., None] * normalizer
    f = scaled * bands
    embed = torch.cat([torch.sin(f), torch.cos(f), scaled], dim=-1)
    return embed.reshape(*coord.shape[:-1],
                         coord.shape[-1] * (2 * n_freqs + 1))


def fourier_grid_embed(shape, embed_dim, device=None):
    """[*shape, embed_dim] sin/cos embedding of the grid over [-1, 1]."""
    num_bands = embed_dim // (2 * len(shape))
    kw = dict(dtype=torch.float32, device=device)
    pos = torch.stack(torch.meshgrid(
        *[torch.linspace(-1.0, 1.0, s, **kw) for s in shape], indexing="ij"),
        dim=-1)
    emb = pos[..., None] * torch.linspace(1.0, num_bands, num_bands, **kw) \
        * math.pi
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1).reshape(
        *shape, embed_dim)


def soft_histogram(values, weights, num_bins):
    """[M, T] fractional bin positions and weights -> [M, num_bins] linear
    soft counts, clamped above to the last bin, nothing below bin 0."""
    lower = torch.floor(values)
    frac = values - lower
    lower = lower.long()
    hist = torch.zeros(values.shape[0], num_bins, device=values.device)
    for idx, w in ((lower, (1.0 - frac) * weights),
                   (lower + 1, frac * weights)):
        idx = idx.clamp(max=num_bins - 1)
        w = torch.where(idx >= 0, w, torch.zeros_like(w))
        hist.scatter_add_(1, idx.clamp(min=0), w)
    return hist


# --------------------------------------------------------------------------- #
# NMP window attention (Inference, Refinement)
# --------------------------------------------------------------------------- #

@lru_cache(maxsize=16)
def relative_position_index(wh, ww):
    """[P, P] table row of (query pixel, key pixel) in a wh x ww window."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@lru_cache(maxsize=32)
def window_mask(Hp, Wp, wh, ww, N, shift, candidate_mask):
    """[nW, T, T] additive mask: candidates of one pixel never see each
    other (``candidate_mask``), and with a shift tokens of different
    shifted regions never see each other."""
    P = wh * ww
    t = np.arange(P * N)
    pix = t // N
    mask = np.zeros((Hp // wh, Wp // ww, P * N, P * N), np.float32)
    if candidate_mask:
        same = (pix[:, None] == pix[None, :]) & (t[:, None] != t[None, :])
        mask += np.where(same, NEG_INF, 0.0).astype(np.float32)
    if shift > 0:
        y = np.arange(Hp // wh)[:, None] * wh + (pix // ww)[None, :]
        x = np.arange(Wp // ww)[:, None] * ww + (pix % ww)[None, :]
        ry = (y >= Hp - wh).astype(int) + (y >= Hp - shift)
        rx = (x >= Wp - ww).astype(int) + (x >= Wp - shift)
        reg = 3 * ry[:, None, :] + rx[None, :, :]
        diff = reg[..., :, None] != reg[..., None, :]
        mask += np.where(diff, NEG_INF, 0.0).astype(np.float32)
    return mask.reshape(-1, P * N, P * N)


def window_attention(qkv, table, shift, window, num_heads, candidate_mask):
    """Attention inside wh x ww windows of qkv [B, Hp, Wp, N, 3C] (q, k, v
    in (component, head, hd) order), with the relative-position table
    [(2wh-1)(2ww-1), 3C] giving q-, k- and v-side positional terms;
    qkv already rolled by the shift.  -> [B, Hp, Wp, N, C]."""
    B, Hp, Wp, N, C3 = qkv.shape
    wh, ww = window
    h = num_heads
    hd = C3 // 3 // h
    P = wh * ww
    T = P * N
    x = qkv.reshape(B, Hp // wh, wh, Wp // ww, ww, N, 3, h, hd)
    x = x.permute(6, 0, 1, 3, 7, 2, 4, 5, 8).reshape(3, -1, h, T, hd)
    q, k, v = x[0], x[1], x[2]
    G = q.shape[0]
    idx = torch.as_tensor(relative_position_index(wh, ww).reshape(-1),
                          device=qkv.device)
    rpe = table[idx].reshape(P, P, h, 3, hd)
    qe, ke, ve = rpe[..., 0, :], rpe[..., 1, :], rpe[..., 2, :]
    scale = hd ** -0.5
    logits = torch.einsum("ghic,ghjc->ghij", q, k) * scale
    q5, k5 = q.reshape(G, h, P, N, hd), k.reshape(G, h, P, N, hd)
    qr = torch.einsum("ghpnc,pshc->ghpns", q5, ke) * scale
    kr = torch.einsum("ghsmc,pshc->ghpsm", k5, qe) * scale
    logits = logits.reshape(G, h, P, N, P, N) + qr[..., None] \
        + kr[:, :, :, None]
    mask = torch.as_tensor(window_mask(Hp, Wp, wh, ww, N, int(shift),
                                       bool(candidate_mask)),
                           device=qkv.device)
    logits = logits.reshape(B, -1, h, T, T) + mask[None, :, None]
    attn = torch.softmax(logits.reshape(G, h, T, T), dim=-1)
    out = attn @ v
    mass = attn.reshape(G, h, P, N, P, N).sum(-1)
    out = out + torch.einsum("ghpns,pshc->ghpnc", mass, ve).reshape(
        G, h, T, hd)
    out = out.reshape(B, Hp // wh, Wp // ww, h, wh, ww, N, hd)
    return out.permute(0, 1, 4, 2, 5, 6, 3, 7).reshape(B, Hp, Wp, N, h * hd)


# --------------------------------------------------------------------------- #
# CSWin stripe attention (Propagation)
# --------------------------------------------------------------------------- #

@lru_cache(maxsize=16)
def stripe_mask(T, N):
    """[T, T]: different candidates of one pixel never see each other."""
    pix = np.arange(T) // N
    same = (pix[:, None] == pix[None, :]) & ~np.eye(T, dtype=bool)
    return np.where(same, NEG_INF, 0.0).astype(np.float32)


def stripe_attention(q, k, v, H_sp, W_sp, num_heads):
    """Attention inside H_sp x W_sp stripes of q, k, v [B, Hp, Wp, N, C]."""
    B, Hp, Wp, N, C = q.shape
    hd = C // num_heads
    T = H_sp * W_sp * N

    def split(t):
        t = t.reshape(B, Hp // H_sp, H_sp, Wp // W_sp, W_sp, N, num_heads, hd)
        return t.permute(0, 1, 3, 6, 2, 4, 5, 7).reshape(-1, num_heads, T, hd)

    mask = torch.as_tensor(stripe_mask(T, N), device=q.device)
    attn = torch.softmax(split(q) * hd ** -0.5 @ split(k).transpose(-1, -2)
                         + mask, dim=-1)
    out = (attn @ split(v)).reshape(B, Hp // H_sp, Wp // W_sp, num_heads, H_sp,
                                    W_sp, N, hd)
    return out.permute(0, 1, 4, 2, 5, 6, 3, 7).reshape(B, Hp, Wp, N, C)


# --------------------------------------------------------------------------- #
# multi-scale deformable attention (the swin variant's neck)
# --------------------------------------------------------------------------- #

def ms_deform_attn(value, spatial_shapes, locations, weights):
    """value [B, S, M, D] (levels flattened), locations [B, Lq, M, L, P, 2]
    in [0, 1] (x, y), weights [B, Lq, M, L, P]: bilinear samples with zero
    padding (``grid_sample``, align_corners False) -> [B, Lq, M * D]."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = locations.shape
    grids = 2.0 * locations - 1.0
    out = value.new_zeros((B, Lq, M, D))
    start = 0
    for lid, (H, W) in enumerate(spatial_shapes):
        v = value[:, start:start + H * W]
        start += H * W
        v = v.reshape(B, H, W, M, D).permute(0, 3, 4, 1, 2).reshape(
            B * M, D, H, W)
        g = grids[:, :, :, lid].permute(0, 2, 1, 3, 4).reshape(B * M, 1,
                                                                Lq * P, 2)
        sampled = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                align_corners=False)
        sampled = sampled[:, :, 0].permute(0, 2, 1).reshape(B * M, Lq, P, D)
        w = weights[:, :, :, lid].permute(0, 2, 1, 3).reshape(B * M, Lq, P)
        out = out + (sampled * w[..., None]).sum(2).reshape(
            B, M, Lq, D).permute(0, 2, 1, 3)
    return out.reshape(B, Lq, M * D)
