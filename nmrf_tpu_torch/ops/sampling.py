"""Horizontal warping and cost gathering (``nmrf_tpu/ops/sampling.py``).

* ``disp_warp``: reference ``Inference.sample_fmap`` (``NMP.py:682-707``),
  horizontal-only bilinear warp, align_corners=True, zeros padding.
* ``sample_cost``: reference ``Propagation.sample_cost`` (``NMP.py:618-634``).
* ``grid_sample_2d``: torch ``F.grid_sample`` on channel-last maps (the
  exact deformable-attention path; the JAX package computes it outside any
  Pallas kernel).
"""

import torch
import torch.nn.functional as F


def disp_warp(fmap, disp, radius=0):
    """Warp ``fmap`` [B, H, W, C] by candidate disparities disp [B, H, W, N].

    Output (h, w, n, tap r) samples fmap at x = w - disp[..., n] - r,
    bilinear in x, zero outside [0, W-1] (so an out-of-range disparity
    gives zeros, never NaN).  Returns [B, H, W, N*(2*radius+1), C],
    tap-major per candidate, in fmap's dtype.
    """
    B, H, W, C = fmap.shape
    N = disp.shape[-1]
    taps = 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, dtype=disp.dtype, device=disp.device)
    xs = torch.arange(W, dtype=disp.dtype, device=disp.device)[None, None, :, None, None]
    x = (xs - disp[..., None] - offs).reshape(B, H, W * N * taps)
    x0 = torch.floor(x)
    frac = x - x0
    x0i = x0.long()
    x1i = x0i + 1
    in0 = (x0i >= 0) & (x0i <= W - 1)
    in1 = (x1i >= 0) & (x1i <= W - 1)

    def gather(idx):  # [B, H, K] -> [B, H, K, C]
        idx = idx.clamp(0, W - 1)[..., None].expand(-1, -1, -1, C)
        return torch.gather(fmap, 2, idx)

    w0 = ((1.0 - frac) * in0)[..., None].to(fmap.dtype)
    w1 = (frac * in1)[..., None].to(fmap.dtype)
    out = gather(x0i) * w0 + gather(x1i) * w1
    return out.reshape(B, H, W, N * taps, C)


def sample_cost(cost_volume, label_seed, radius=4):
    """Per-seed local cost profiles.

    cost_volume: [M, G, D]; label_seed: [M, N] integer seeds.  Taps at
    seed + [-radius, radius], clamped to [0, D-1].  Returns
    [M, N, G*(2*radius+1)], group-major per candidate.
    """
    M, G, D = cost_volume.shape
    N = label_seed.shape[1]
    taps = 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, device=label_seed.device)
    idx = (label_seed.long()[:, :, None] + offs).clamp(0, D - 1)  # [M, N, taps]
    idx = idx.reshape(M, 1, N * taps).expand(M, G, N * taps)
    out = torch.gather(cost_volume, 2, idx).reshape(M, G, N, taps)
    return out.permute(0, 2, 1, 3).reshape(M, N, G * taps)


def grid_sample_2d(img, grid, align_corners=False):
    """Bilinear sampling with zeros padding, ``F.grid_sample`` semantics.

    img: [B, H, W, C]; grid: [B, ..., 2] normalized (x, y) in [-1, 1].
    Samples in float32 and returns [B, ..., C] in img's dtype.
    """
    B, H, W, C = img.shape
    lead = grid.shape[1:-1]
    g = grid.reshape(B, 1, -1, 2).float()
    out = F.grid_sample(img.permute(0, 3, 1, 2).float(), g, mode="bilinear",
                        padding_mode="zeros", align_corners=align_corners)
    return out[:, :, 0].permute(0, 2, 1).reshape(B, *lead, C).to(img.dtype)
