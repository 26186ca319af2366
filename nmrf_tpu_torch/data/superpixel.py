"""Host-side SLIC-lite superpixel generator for the proposal metrics (the
port's copy of ``nmrf_tpu/data/superpixel.py``, the same numpy
arithmetic, so the same labels).

The reference evaluator pools full-res GT disparity by superpixel label
(``nmrf/utils/evaluation.py:363-366``) but its snapshot ships neither the
``downsample_disp`` op source nor any ``super_pixel_label`` producer — the
metric silently never runs there.  We complete the chain: this module
produces the labels (host numpy, eval-time only), ``ops/downsample.py``
pools GT by them, and ``DispEvaluator`` consumes the result, so
``prop_epe / prop_recall_*`` here are genuinely superpixel-guided.

Algorithm: SLIC (Achanta et al., TPAMI 2012) restricted to the metric's
needs — centers initialised on the 1/8 cell grid (S = 8), assignment over
the 3x3 neighbouring centers in joint (RGB, xy) space, a few
assign/update iterations.  Fully vectorised numpy.
"""

import numpy as np


def slic_segments(image, cell: int = 8, iters: int = 2,
                  compactness: float = 10.0):
    """Segment ``image`` into ~(H/cell)*(W/cell) superpixels.

    Args:
      image: [H, W, 3] float array (0..255 scale).
      cell: grid spacing S (8 matches the 1/8 proposal grid).
      iters: assign/update iterations (2 is enough at S=8).
      compactness: SLIC m — spatial-vs-color weight.
    Returns:
      [H, W] int64 labels in [0, (H//cell)*(W//cell)); label ci*w + cj is
      the superpixel seeded at grid cell (ci, cj).
    """
    H, W = image.shape[:2]
    h, w = max(H // cell, 1), max(W // cell, 1)
    Hc, Wc = h * cell, w * cell
    img = np.asarray(image[:Hc, :Wc, :3], np.float32)

    # init: per-cell mean color + geometric centers
    ccol = (img.reshape(h, cell, w, cell, 3)
               .transpose(0, 2, 1, 3, 4).reshape(h, w, -1, 3).mean(2))
    # (cell-1)/2 is the true geometric center of rows [i*cell, (i+1)*cell);
    # cell/2 would leave boundary pixels equidistant to two centers
    cy = (np.arange(h, dtype=np.float32) * cell + (cell - 1) / 2)[:, None] \
        * np.ones((1, w), np.float32)
    cx = np.ones((h, 1), np.float32) \
        * (np.arange(w, dtype=np.float32) * cell + (cell - 1) / 2)[None, :]

    yy, xx = np.meshgrid(np.arange(Hc, dtype=np.float32),
                         np.arange(Wc, dtype=np.float32), indexing="ij")
    ci0 = np.minimum((yy / cell).astype(np.int64), h - 1)
    cj0 = np.minimum((xx / cell).astype(np.int64), w - 1)
    m2 = (compactness / cell) ** 2
    labels = ci0 * w + cj0

    for _ in range(iters):
        best = np.full((Hc, Wc), np.inf, np.float32)
        newlab = labels
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                ci = np.clip(ci0 + di, 0, h - 1)
                cj = np.clip(cj0 + dj, 0, w - 1)
                d = (((img - ccol[ci, cj]) ** 2).sum(-1)
                     + m2 * ((yy - cy[ci, cj]) ** 2 + (xx - cx[ci, cj]) ** 2))
                better = d < best
                best = np.where(better, d, best)
                newlab = np.where(better, ci * w + cj, newlab)
        labels = newlab

        flat = labels.ravel()
        cnt = np.maximum(np.bincount(flat, minlength=h * w), 1).astype(np.float32)
        for c in range(3):
            s = np.bincount(flat, weights=img[..., c].ravel(), minlength=h * w)
            ccol[..., c] = (s / cnt).reshape(h, w)
        cy = (np.bincount(flat, weights=yy.ravel(), minlength=h * w)
              / cnt).reshape(h, w)
        cx = (np.bincount(flat, weights=xx.ravel(), minlength=h * w)
              / cnt).reshape(h, w)

    if Hc == H and Wc == W:
        return labels
    out = np.zeros((H, W), np.int64)
    out[:Hc, :Wc] = labels
    if Hc < H:
        out[Hc:, :Wc] = out[Hc - 1 : Hc, :Wc]
    if Wc < W:
        out[:, Wc:] = out[:, Wc - 1 : Wc]
    return out
