"""Synthetic stereo data: random-dot stereograms with exact ground truth
(``nmrf_tpu/data/synthetic.py``).

The right image is random dots; the left image is it warped by a
piecewise-constant disparity field (fronto-parallel rectangles over a
background), so a stereo matcher can fit it.  numpy only: the same seed
gives the same draws, and so the same arrays, as the JAX package.
"""

import numpy as np


def make_stereo_pair(height, width, max_disp=32, num_rects=4, rng=None,
                     dot_density=0.6, disp_quantum=1):
    """Returns (img1, img2, disp, valid) float32/bool numpy arrays.

    img1/img2: [H, W, 3] in 0..255; disp: [H, W] >= 0; valid: [H, W].
    disp_quantum: round every disparity up to a multiple of this (8 matches
    one bin of the 1/8-resolution cost volume).
    """
    rng = rng or np.random.RandomState(0)
    H, W = height, width

    def q(d):
        if disp_quantum <= 1:
            return float(d)
        return float(max(disp_quantum,
                         int(round(d / disp_quantum)) * disp_quantum))

    disp = np.full((H, W), q(rng.randint(2, max(3, max_disp // 4))), np.float32)
    for _ in range(num_rects):
        d = q(rng.randint(2, max_disp))
        h0 = rng.randint(0, H // 2)
        w0 = rng.randint(0, W // 2)
        h1 = rng.randint(h0 + H // 8, H)
        w1 = rng.randint(w0 + W // 8, W)
        disp[h0:h1, w0:w1] = d

    # random-dot texture (the right view)
    base = (rng.rand(H, W, 3) > (1 - dot_density)).astype(np.float32)
    base *= rng.rand(H, W, 3)
    base = (base * 255).astype(np.float32)

    # left pixel x corresponds to right pixel x - d: img1[y, x] = img2[y, x - d]
    xs = np.arange(W)
    di = np.round(disp).astype(np.int64)
    img2 = base
    img1 = base[np.arange(H)[:, None], np.clip(xs[None, :] - di, 0, W - 1), :]
    valid = (xs[None, :] - di) >= 0
    return img1, img2, np.round(disp), valid


class SyntheticStereoDataset:
    """Map-style dataset of random-dot stereo pairs (fixed seed per index)."""

    def __init__(self, size=64, height=256, width=512, max_disp=64, seed=0):
        self.size = size
        self.height = height
        self.width = width
        self.max_disp = max_disp
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed * 100003 + idx)
        img1, img2, disp, valid = make_stereo_pair(
            self.height, self.width, self.max_disp, rng=rng)
        return {"img1": img1, "img2": img2, "disp": disp.astype(np.float32),
                "valid": valid}


def synthetic_batch(batch, height, width, max_disp, seed=0, disp_quantum=1):
    """A stacked batch of the pairs ``SyntheticStereoDataset(batch, height,
    width, max_disp, seed)`` holds (the same draws), with every disparity
    rounded up to a multiple of ``disp_quantum``: img1/img2 [B, H, W, 3]
    float32, disp [B, H, W] float32, valid [B, H, W] bool."""
    items = []
    for idx in range(batch):
        rng = np.random.RandomState(seed * 100003 + idx)
        items.append(make_stereo_pair(height, width, max_disp, rng=rng,
                                      disp_quantum=disp_quantum))
    img1, img2, disp, valid = (np.stack(x) for x in zip(*items))
    return {"img1": img1, "img2": img2, "disp": disp.astype(np.float32),
            "valid": valid}
