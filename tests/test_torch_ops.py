"""PyTorch port ops against the JAX package on identical numpy inputs (CPU).

Tolerance: float32, atol 1e-5 (the same f32 arithmetic in another
summation order); integer outputs must be equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nmrf_tpu.data.frame_io import InputPadder as InputPadderJax
from nmrf_tpu.ops import correlation as corr_jax
from nmrf_tpu.ops import encodings as enc_jax
from nmrf_tpu.ops import nms as nms_jax
from nmrf_tpu.ops import sampling as samp_jax
from nmrf_tpu_torch.data import InputPadder
from nmrf_tpu_torch.ops import (
    correlation_volume,
    disp_warp,
    fourier_coord_embed,
    fourier_grid_embed,
    nms_topk_seeds,
    sample_cost,
)

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("W,D", [(16, 5), (6, 9)])  # second case: D > W
def test_correlation_volume(W, D):
    rng = np.random.RandomState(0)
    f1 = rng.randn(2, 3, W, 16).astype(np.float32)
    f2 = rng.randn(2, 3, W, 16).astype(np.float32)
    got = correlation_volume(_t(f1), _t(f2), D, 4).numpy()
    want = np.asarray(corr_jax.correlation_volume(jnp.asarray(f1),
                                                  jnp.asarray(f2), D, 4))
    golden = np.asarray(corr_jax.correlation_volume_golden(
        jnp.asarray(f1), jnp.asarray(f2), D, 4))
    assert got.shape == (2, 3, W, 4, D)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, golden, atol=ATOL, rtol=0)
    assert (got[:, :, :, :, W:] == 0).all()  # out-of-range band is zero


def test_nms_topk_seeds_with_ties():
    rng = np.random.RandomState(1)
    logits = rng.randn(64, 12).astype(np.float32)
    # exact plateaus: zero-filled correlation makes equal probabilities
    logits[:16, :6] = 0.0
    logits[16:32] = 0.5
    logits[32:40, ::2] = 2.0
    prob = np.asarray(torch.softmax(_t(logits), -1))
    got = nms_topk_seeds(_t(prob), 4).numpy()
    want = np.asarray(nms_jax.nms_topk_seeds(jnp.asarray(prob), 4))
    np.testing.assert_array_equal(got, want)


def test_disp_warp_out_of_range_is_zero():
    rng = np.random.RandomState(2)
    fmap = rng.randn(1, 4, 10, 6).astype(np.float32)
    disp = rng.uniform(-3.0, 14.0, (1, 4, 10, 3)).astype(np.float32)
    disp[0, :, :, 2] = 1e4  # far out of range
    got = disp_warp(_t(fmap), _t(disp)).numpy()
    want = np.asarray(samp_jax.disp_warp(jnp.asarray(fmap), jnp.asarray(disp)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert (got[:, :, :, 2] == 0).all()


def test_sample_cost_clamps():
    rng = np.random.RandomState(3)
    cost = rng.randn(20, 4, 9).astype(np.float32)
    seeds = rng.randint(0, 9, (20, 4)).astype(np.int32)
    seeds[0] = [0, 8, 1, 7]  # taps run past both ends of D
    got = sample_cost(_t(cost), _t(seeds).long()).numpy()
    want = np.asarray(samp_jax.sample_cost(jnp.asarray(cost), jnp.asarray(seeds)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("normalizer", [3.14 / 64, 3.14 / 128])
def test_fourier_coord_embed(normalizer):
    coord = np.random.RandomState(4).uniform(0, 40, (5, 7, 1)).astype(np.float32)
    got = fourier_coord_embed(_t(coord), 15, normalizer=normalizer).numpy()
    want = np.asarray(enc_jax.fourier_coord_embed(jnp.asarray(coord), 15,
                                                  normalizer=normalizer))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_fourier_grid_embed():
    got = fourier_grid_embed((6, 9), 16).numpy()
    want = np.asarray(enc_jax.fourier_grid_embed((6, 9), 16))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["proposal", "sintel", "kitti"])
def test_input_padder(mode):
    img = np.random.RandomState(5).rand(375, 1242, 3).astype(np.float32)
    ours, theirs = InputPadder(img.shape, mode), InputPadderJax(img.shape, mode)
    padded = ours.pad(img)[0]
    np.testing.assert_array_equal(padded, theirs.pad(img)[0])
    assert padded.shape[0] % 8 == 0 and padded.shape[1] % 8 == 0
    np.testing.assert_array_equal(ours.unpad(padded[..., 0]), img[..., 0])
