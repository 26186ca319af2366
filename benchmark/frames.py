"""Synthetic stereo frames from a seed: random-dot stereograms with exact
ground truth (a background plane and rectangles at whole-pixel
disparities), the benchmark's traffic.  numpy on the host, one
``numpy.random.Generator`` per call, so the same seed gives the same
frames."""

import numpy as np


def rng(seed, stream):
    """The generator of one use (``stream``) of a run's seed."""
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


def stereo_pair(gen, height, width, max_disp, rects=4):
    """(left, right, disp, valid): uint8 [H, W, 3] images, float32 [H, W]
    disparity in [2, max_disp), bool [H, W] (the pixels whose match lies in
    the right image).  left[y, x] = right[y, x - disp[y, x]]."""
    H, W = height, width
    disp = np.full((H, W), gen.integers(2, max(3, max_disp // 4)), np.float32)
    for _ in range(rects):
        d = gen.integers(2, max_disp)
        h0, w0 = gen.integers(0, H // 2), gen.integers(0, W // 2)
        h1, w1 = gen.integers(h0 + H // 8, H), gen.integers(w0 + W // 8, W)
        disp[h0:h1, w0:w1] = d
    dots = gen.random((H, W, 3), dtype=np.float32)
    right = np.where(dots > 0.4, dots * 255.0, 0.0).astype(np.uint8)
    xs = np.arange(W)
    src = xs[None, :] - disp.astype(np.int64)
    left = right[np.arange(H)[:, None], np.clip(src, 0, W - 1)]
    return left, right, disp, src >= 0


def pad_to(x, divis_by):
    """[..., H, W, C] padded right and bottom by edge replication to
    multiples of ``divis_by`` (the NMRF eval padding)."""
    H, W = x.shape[-3:-1]
    pads = [(0, 0)] * x.ndim
    pads[-3] = (0, -H % divis_by)
    pads[-2] = (0, -W % divis_by)
    return np.pad(x, pads, mode="edge")
