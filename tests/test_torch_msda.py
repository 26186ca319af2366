"""The port's deformable-attention ops against the JAX package (CPU, f32).

The same numpy inputs, made from a seed, go through ``nmrf_tpu.ops.msda``
and ``nmrf_tpu_torch.ops.msda``.  The JAX tap kernel runs as
``tests/test_msda_taps.py`` runs it (``_tap_level_op``, Pallas in interpret
mode on the CPU).  Tolerance: atol 2e-5, rtol 1e-5, the JAX tests' own (the
same f32 sums in another order); the tap inputs dx/dy/aw must be equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nmrf_tpu.ops import msda as msda_jax
from nmrf_tpu_torch.ops import _native
from nmrf_tpu_torch.ops import msda

TOL = dict(atol=2e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _grid_ref_points(Hq, Wq):
    ry, rx = np.meshgrid((np.arange(Hq) + 0.5) / Hq, (np.arange(Wq) + 0.5) / Wq,
                         indexing="ij")
    return np.stack([rx.reshape(-1), ry.reshape(-1)], -1)


def _msda_case(rng, Hq, Wq, levels, M, D, P, max_off, B=2):
    """value [B, S, M, D], grid-aligned locations with offsets within
    ``max_off`` level pixels, and weights normalized over levels and
    points."""
    S = sum(h * w for h, w in levels)
    value = rng.randn(B, S, M, D).astype(np.float32)
    offs = np.clip(rng.randn(B, Hq * Wq, M, len(levels), P, 2) * max_off / 2.0,
                   -max_off, max_off)
    norm = np.array([[w, h] for h, w in levels], np.float64)
    ref = _grid_ref_points(Hq, Wq)
    locs = (ref[None, :, None, None, None, :] + offs / norm[:, None, :])
    w = rng.rand(B, Hq * Wq, M, len(levels), P)
    w = w / w.sum((-2, -1), keepdims=True)
    return (value, locs.astype(np.float32), w.astype(np.float32))


def _tap_case(rng, f, r, B=2, Hq=16, Wq=24, M=2, D=4, P=3):
    """Level map and tap inputs with displacements up to r + 2 (some beyond
    the radius, which must drop; base + d past the border for edge queries)
    and a share of them on whole pixels (the hat's kinks)."""
    vmap = rng.randn(B, Hq // f, Wq // f, M * D).astype(np.float32)
    dx, dy = (rng.uniform(-r - 2, r + 2, (B, Hq, Wq, M * P)).astype(np.float32)
              for _ in range(2))
    whole = rng.rand(*dx.shape) < 0.2
    dx[whole] = np.round(dx[whole])
    aw = rng.rand(B, Hq, Wq, M * P).astype(np.float32)
    return vmap, dx, dy, aw


@pytest.mark.parametrize("r", [2, 5])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_tap_plain_matches_jax(f, r):
    """The port's plain tap version against ``_tap_level_reference`` and
    against the Pallas kernel ``_tap_level_op``, at every level factor of
    the swin neck, with samples past the border and beyond the radius."""
    rng = np.random.RandomState(10 * f + r)
    vmap, dx, dy, aw = _tap_case(rng, f, r)
    got = msda.msda_taps_plain(_t(vmap), _t(dx), _t(dy), _t(aw), 2, r).numpy()
    args = tuple(jnp.asarray(x) for x in (vmap, dx, dy, aw))
    want = np.asarray(msda_jax._tap_level_reference(*args, 2, r))
    np.testing.assert_allclose(got, want, **TOL)
    kernel = np.asarray(msda_jax._tap_level_op(*args, 2, r))
    np.testing.assert_allclose(got, kernel, **TOL)
    # the case reaches past the radius: an r-clipped copy drops terms
    assert (np.abs(dx) > r + 1).any() and (np.abs(dy) > r + 1).any()


def test_tap_drops_samples_beyond_radius():
    """A sample displaced more than r + 1 from its base cell contributes
    nothing; one at exactly r keeps its whole weight on that corner."""
    rng = np.random.RandomState(3)
    r = 2
    vmap, dx, dy, aw = _tap_case(rng, 2, r, P=1)
    far = np.full_like(dx, r + 1.5)
    out = msda.msda_taps(_t(vmap), _t(far), _t(dy), _t(aw), 2, r).numpy()
    np.testing.assert_array_equal(out, 0.0)
    edge = np.full_like(dx, float(r))
    zero = np.zeros_like(dy)
    got = msda.msda_taps(_t(vmap), _t(edge), _t(zero), _t(aw), 2, r).numpy()
    ly = msda.base_plus_one(16, 2) - 1       # base row, ty = 0
    lx = msda.base_plus_one(24, 2) - 1 + r   # base column + r
    inside = (ly >= 0)[:, None] & (lx < vmap.shape[2])[None, :]
    want = vmap[:, np.maximum(ly, 0)][:, :, np.minimum(lx, vmap.shape[2] - 1)]
    want = want.reshape(2, 16, 24, 2, 4) * aw.reshape(2, 16, 24, 2, 1)
    want = want.reshape(2, 16, 24, 8) * inside[None, :, :, None]
    np.testing.assert_allclose(got, want, **TOL)


def test_tap_level_inputs_match_jax():
    rng = np.random.RandomState(4)
    levels = [(8, 16), (4, 8), (2, 4), (1, 2)]
    _, locs, w = _msda_case(rng, 8, 16, levels, 2, 4, 3, 3.0)
    for lid, level in enumerate(levels):
        got = msda.tap_level_inputs(_t(locs[:, :, :, lid]), _t(w[:, :, :, lid]),
                                    level, (8, 16))
        want = msda_jax._tap_level_inputs(jnp.asarray(locs[:, :, :, lid]),
                                          jnp.asarray(w[:, :, :, lid]),
                                          level, (8, 16))
        for name, a, b in zip(("dx", "dy", "aw"), got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"level {lid} {name}")


def test_ms_deform_attn_matches_jax():
    """The exact gather path, samples reaching past every border."""
    rng = np.random.RandomState(5)
    levels = [(6, 10), (3, 5)]
    value = rng.randn(2, 75, 2, 4).astype(np.float32)
    locs = rng.uniform(-0.2, 1.2, (2, 7, 2, 2, 3, 2)).astype(np.float32)
    w = rng.rand(2, 7, 2, 2, 3).astype(np.float32)
    got = msda.ms_deform_attn(_t(value), levels, _t(locs), _t(w)).numpy()
    want = msda_jax.ms_deform_attn(jnp.asarray(value), levels,
                                   jnp.asarray(locs), jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_ms_deform_attn_taps_matches_jax():
    """Multi-level tap path (f 1, 2, 4) with offsets within r - 1: the
    port's equals JAX's kernel path and the exact gather path."""
    rng = np.random.RandomState(6)
    levels = [(8, 16), (4, 8), (2, 4)]
    r = 3
    value, locs, w = _msda_case(rng, 8, 16, levels, 2, 4, 2, r - 1)
    got = msda.ms_deform_attn_taps(_t(value), levels, _t(locs), _t(w), (8, 16),
                                   r).numpy()
    args = (jnp.asarray(value), levels, jnp.asarray(locs), jnp.asarray(w))
    want = msda_jax.ms_deform_attn_taps(*args, (8, 16), r, use_kernel=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    exact = msda_jax.ms_deform_attn(*args)
    np.testing.assert_allclose(got, np.asarray(exact), **TOL)
    plain = msda.ms_deform_attn_taps(_t(value), levels, _t(locs), _t(w),
                                     (8, 16), r, use_kernels=False).numpy()
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("max_off", [2.0, 6.0])
def test_tap_out_of_range_fraction_matches_jax(max_off):
    rng = np.random.RandomState(7)
    levels = [(8, 16), (4, 8)]
    _, locs, _ = _msda_case(rng, 8, 16, levels, 2, 4, 3, max_off)
    got = float(msda.tap_out_of_range_fraction(_t(locs), levels, (8, 16), 3))
    want = float(msda_jax.tap_out_of_range_fraction(jnp.asarray(locs), levels,
                                                    (8, 16), 3))
    assert got == pytest.approx(want, abs=1e-6)  # a mean over 0/1 flags
    assert (got == 0.0) == (max_off < 3.0)


def test_cpu_wrapper_takes_the_plain_version_and_counts_no_launch():
    _native.reset_launch_counts()
    rng = np.random.RandomState(8)
    vmap, dx, dy, aw = (_t(x) for x in _tap_case(rng, 2, 2))
    got = msda.msda_taps(vmap, dx, dy, aw, 2, 2)
    want = msda.msda_taps_plain(vmap, dx, dy, aw, 2, 2)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert _native.launch_counts()["msda_taps"] == 0
    with pytest.raises(ValueError, match="whole"):
        msda.msda_taps(vmap[:, :, :5], dx, dy, aw, 2, 2)
    with pytest.raises(TypeError, match="float32"):
        msda.msda_taps(vmap, dx.double(), dy, aw, 2, 2)


@pytest.mark.parametrize("f,r,q0,margin", [
    (1, 5, 12, 1), (2, 5, 24, 0), (4, 2, 12, 1),
    (8, 5, 12, 1),   # q0 not a multiple of f
    (8, 5, 36, 2),   # the last tile: its map past the bottom edge
    (1, 2, 0, 3),    # the first tile: its map past the top edge
])
def test_tap_plain_at_an_offset_is_the_whole_map_cut_to_the_tile(f, r, q0,
                                                                 margin):
    """On an H tile (query rows q0 .. q0 + 11 of 48, the level map's rows
    the tile reads within r plus ``margin`` each side, zero past the global
    edges as the halo exchange gives them) the plain tap version equals
    the whole map's, cut to the tile; the wrapper takes it on the CPU, and
    a map that lacks a row the tile reads raises."""
    rng = np.random.RandomState(20 + 7 * f + r + q0)
    Hq, hq = 48, 12
    vmap, dx, dy, aw = _tap_case(rng, f, r, Hq=Hq, Wq=16)
    Hl = Hq // f
    want = msda.msda_taps_plain(_t(vmap), _t(dx), _t(dy), _t(aw), 2, r)
    lo, hi = msda.tap_value_rows(hq, f, r, q0, Hl)
    v0 = lo - margin
    padded = np.pad(vmap, ((0, 0), (margin, margin), (0, 0), (0, 0)))
    local = _t(padded[:, v0 + margin:hi + 2 * margin])
    tile = [_t(x[:, q0:q0 + hq]) for x in (dx, dy, aw)]
    got = msda.msda_taps_plain(local, *tile, 2, r, q0, v0, Hl)
    torch.testing.assert_close(got, want[:, q0:q0 + hq], atol=1e-6, rtol=0)
    torch.testing.assert_close(msda.msda_taps(local, *tile, 2, r, q0, v0, Hl),
                               got, atol=0, rtol=0)
    with pytest.raises(ValueError, match="do not hold"):
        msda.msda_taps(local[:, 1:], *tile, 2, r, q0, v0 + margin + 1, Hl)
