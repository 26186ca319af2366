"""Disparity-modal extraction: softmax + 3-tap NMS + top-k
(``nmrf_tpu/ops/nms.py``; reference ``nmrf/models/DPN.py:115-125``)."""

import torch
import torch.nn.functional as F


def max_pool_1d_3(x):
    """3-tap max pool along the last axis, stride 1, -inf padding."""
    xp = F.pad(x, (1, 1), value=float("-inf"))
    return torch.maximum(torch.maximum(xp[..., :-2], xp[..., 1:-1]), xp[..., 2:])


def nms_topk_seeds(prob, k, eps=1e-3):
    """Suppress non-local-max probabilities, then take the top-k indices.

    prob: [..., D] softmax probabilities.  Returns [..., k] int64 seeds in
    descending value order, ties broken lowest index first (the order of
    ``lax.top_k``; a stable descending sort, since ``torch.topk``'s tie
    order is unspecified and plateaus occur wherever the correlation is
    zero-filled).
    """
    pooled = max_pool_1d_3(prob)
    non_local_max = (prob != pooled) & (prob > eps)
    prob_ = torch.where(non_local_max, torch.full_like(prob, eps), prob)
    return torch.argsort(prob_, dim=-1, descending=True, stable=True)[..., :k]
