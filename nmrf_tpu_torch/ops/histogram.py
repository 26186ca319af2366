"""Soft disparity histogram for the init-distribution loss
(``nmrf_tpu/ops/histogram.py``; reference ``Criterion.loss_init``,
``nmrf/models/NMRF.py:343-358``)."""

import torch


def soft_histogram(values, weights, num_bins):
    """Accumulate linearly interpolated soft counts into histogram bins.

    values: [M, T] fractional bin positions; weights: [M, T] per-sample
    weights (0 for invalid); num_bins: D.  Returns [M, D] in values' dtype:
    each value v adds (1 - frac) to floor(v) and frac to floor(v) + 1, both
    clamped above to D - 1 (the reference's clamp); a bin below 0 receives
    nothing, as the JAX package's one-hot matches no bin there.
    """
    lower = torch.floor(values)
    frac = values - lower
    lower = lower.long()
    hist = torch.zeros(values.shape[0], num_bins, dtype=torch.float32,
                       device=values.device)
    for idx, w in ((lower, (1.0 - frac) * weights), (lower + 1, frac * weights)):
        idx = idx.clamp(max=num_bins - 1)
        w = torch.where(idx >= 0, w, torch.zeros_like(w)).float()
        hist.scatter_add_(1, idx.clamp(min=0), w)
    return hist.to(values.dtype)
