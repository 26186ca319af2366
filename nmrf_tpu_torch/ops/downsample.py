"""Superpixel-guided disparity downsampling (the port's copy of
``nmrf_tpu/ops/downsample.py``; the reference evaluator's
``frame_utils.downsample_disp``, whose source the reference snapshot lacks).

For each 8x8 cell, the majority superpixel label among the valid pixels
(disp > 0) wins, and the cell's value is the mean disparity of the valid
pixels carrying that label; 0 if the cell has no valid pixel.  Dense
per-cell equality products, no scatter.  numpy arrays stay on the host (the
evaluator's path, per frame); torch tensors stay on their device.
"""

import numpy as np
import torch


def downsample_disp(disp, label, factor=8):
    """Label-guided pooled disparity downsample.

    Args:
      disp: [B, H, W] ground-truth disparity (0 = invalid), numpy or torch.
      label: [B, H, W] integer superpixel assignment, of the same kind.
      factor: cell size (8 in the reference metric path).
    Returns:
      [B, H//factor, W//factor] pooled disparity (in full-res units), of
      the input's kind.
    """
    B, H, W = disp.shape
    f = factor
    h, w = H // f, W // f

    def cells(x):
        x = x[:, : h * f, : w * f].reshape(B, h, f, w, f)
        return x.transpose(2, 3) if torch.is_tensor(x) else \
            x.transpose(0, 1, 3, 2, 4)

    if torch.is_tensor(disp):
        d = cells(disp).reshape(B, h, w, f * f)
        lab = cells(label).reshape(B, h, w, f * f)
        valid = (d > 0).to(disp.dtype)
        same = (lab[..., :, None] == lab[..., None, :]).to(disp.dtype)
        votes = torch.einsum("bhwij,bhwj->bhwi", same, valid)
        votes = torch.where(valid > 0, votes, torch.full_like(votes, -1.0))
        winner = votes.argmax(dim=-1)
        win_match = torch.take_along_dim(
            same, winner[..., None, None], dim=-2).squeeze(-2)
        sel = win_match * valid
        count = sel.sum(dim=-1)
        pooled = (d * sel).sum(dim=-1) / count.clamp(min=1.0)
        return torch.where(count > 0, pooled, torch.zeros_like(pooled))

    d = cells(disp).reshape(B, h, w, f * f)
    lab = cells(label).reshape(B, h, w, f * f)
    valid = (d > 0).astype(disp.dtype)
    same = (lab[..., :, None] == lab[..., None, :]).astype(disp.dtype)
    votes = np.einsum("bhwij,bhwj->bhwi", same, valid)
    votes = np.where(valid > 0, votes, -1.0)  # invalid pixels can't win
    winner = np.argmax(votes, axis=-1)
    win_match = np.take_along_axis(same, winner[..., None, None],
                                   axis=-2).squeeze(-2)
    sel = win_match * valid  # valid pixels sharing the winning label
    count = sel.sum(axis=-1)
    pooled = (d * sel).sum(axis=-1) / np.maximum(count, 1.0)
    return np.where(count > 0, pooled, 0.0)
