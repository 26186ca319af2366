"""Group-wise correlation cost volume (``nmrf_tpu/ops/correlation.py``;
reference ``nmrf/models/submodule.py:4-23``).  Channel-last; output
[B, H, W, G, D]."""

import torch


def correlation_volume(f1, f2, max_disp, num_groups):
    """out[b, h, w, g, d] = mean_c f1[b, h, w, g, c] * f2[b, h, w - d, g, c],
    zero where w < d (any D, including D > W).

    One batched product gives the full [W, W'] row correlation in float32;
    the D-wide lower band is then gathered.  Returns f1's dtype.
    """
    B, H, W, C = f1.shape
    G = num_groups
    c = C // G
    a = f1.reshape(B, H, W, G, c).float()
    b = f2.reshape(B, H, W, G, c).float()
    full = torch.einsum("bhwgc,bhvgc->bhgwv", a, b) / c      # [B,H,G,W,W']
    src = (torch.arange(W, device=f1.device)[:, None]
           - torch.arange(max_disp, device=f1.device)[None, :])  # [W, D]
    valid = src >= 0
    idx = src.clamp(0, W - 1).expand(B, H, G, W, max_disp)
    band = torch.gather(full, -1, idx)
    band = torch.where(valid, band, torch.zeros((), device=f1.device))
    return band.permute(0, 1, 3, 2, 4).to(f1.dtype)
