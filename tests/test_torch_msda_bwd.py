"""The tap-MSDA backward B5b on the CPU: the port against the JAX package
(float32).

* ``msda_taps_bwd_plain`` against ``nmrf_tpu.ops.msda._tap_bwd`` at every
  level factor of the swin neck and radii 2 and 5, with samples beyond the
  radius and past the borders, displacements at least 1e-3 from the hat's
  kinks: atol 1e-5 (the same f32 sums in another order);
* ``TapLevel`` (the autograd function, here on its plain versions)
  against ``jax.vjp`` of ``_tap_level_op`` (the Pallas B5 in interpret
  mode and ``_tap_bwd``) at atol 2e-5, rtol 1e-5
  (``tests/test_torch_msda.py``'s), and ``ms_deform_attn_taps``'s gradients
  against the JAX one's at atol 1e-4 (the locations' gradients carry the
  level width, up to 16, as a factor);
* a model of ``csrc/msda_taps_bwd.cu`` in PyTorch against the plain
  version on ragged shapes, with a share of the displacements on whole
  pixels (the kinks, where both take 0), atol 1e-5: the sample kernel's
  corner walk per sample and its tap masks; up to r 5 the cell masks (the
  OR of each base cell's query masks), the gather kernel's kept cells in
  tap order, its lanes splitting each cell's queries (j mod L) with a
  query's own mask bit tested at f > 1, and the xor butterfly over the
  lanes; past r 5 the walk over every base cell within r.  With the swin
  neck's samples (each head's points along one direction), the masks keep
  only part of the cells and of their queries.
* on an H tile (query rows from q0, the level map's rows from v0, with
  halo rows past the global edges): the plain version and the kernel's
  model at those offsets equal the plain version on the whole map, cut to
  the tile's queries and the map's rows, with the whole map's g zero
  outside the tile, atol 1e-5 (the same sums; d value gathers only the
  tile's queries); the model's base cells, first query rows and cell
  masks are the ``.cu``'s forms with ``qy0``, ``vy0`` and ``oy``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from nmrf_tpu.ops import msda as msda_jax
from nmrf_tpu_torch.ops import _native
from nmrf_tpu_torch.ops import msda

from .test_torch_swin_train import few_threads  # noqa: F401

TOL = dict(atol=1e-5, rtol=0)
TOL_OP = dict(atol=2e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _off_kinks(x, margin=1e-3):
    """x moved at least ``margin`` away from every integer."""
    frac = x - np.floor(x)
    return (np.floor(x) + np.clip(frac, margin, 1 - margin)).astype(np.float32)


def _case(rng, f, r, B=2, Hq=16, Wq=24, M=2, D=4, P=3, whole=0.0):
    """Level map, displacements up to r + 2 (some beyond the radius, and
    base + d past the border for edge queries), weights and a cotangent;
    ``whole``: the share of displacements put on whole pixels, else every
    displacement is kept 1e-3 off the kinks."""
    vmap = rng.randn(B, Hq // f, Wq // f, M * D).astype(np.float32)
    dx, dy = (_off_kinks(rng.uniform(-r - 2, r + 2, (B, Hq, Wq, M * P)))
              for _ in range(2))
    for d in (dx, dy):
        on = rng.rand(*d.shape) < whole
        d[on] = np.round(d[on])
    aw = rng.rand(B, Hq, Wq, M * P).astype(np.float32)
    g = rng.randn(B, Hq, Wq, M * D).astype(np.float32)
    return vmap, dx, dy, aw, g


@pytest.mark.parametrize("r", [2, 5])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_bwd_plain_matches_jax(f, r):
    rng = np.random.RandomState(100 + 10 * f + r)
    vmap, dx, dy, aw, g = _case(rng, f, r)
    assert (np.abs(dx) > r + 1).any() and (np.abs(dy) > r + 1).any()
    want = msda_jax._tap_bwd(2, r, tuple(jnp.asarray(x) for x in
                                         (vmap, dx, dy, aw)), jnp.asarray(g))
    got = msda.msda_taps_bwd_plain(_t(vmap), _t(dx), _t(dy), _t(aw), _t(g), 2, r)
    for name, a, b in zip(("dv", "ddx", "ddy", "daw"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=f"{name} f={f} r={r}")


@pytest.mark.parametrize("f", [1, 4])
def test_tap_level_function_matches_jax_vjp(f):
    """TapLevel's forward and its four gradients against jax.vjp of
    ``_tap_level_op`` (the Pallas kernel's forward, ``_tap_bwd``)."""
    r = 3
    rng = np.random.RandomState(f)
    vmap, dx, dy, aw, g = _case(rng, f, r, Hq=8, Wq=16)
    args = tuple(jnp.asarray(x) for x in (vmap, dx, dy, aw))
    want_out, vjp = jax.vjp(lambda *a: msda_jax._tap_level_op(*a, 2, r), *args)
    want = vjp(jnp.asarray(g))
    inputs = [_t(x).requires_grad_() for x in (vmap, dx, dy, aw)]
    out = msda.TapLevel.apply(*inputs, 2, r, True)
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL_OP)
    for name, x, b in zip(("dv", "ddx", "ddy", "daw"), inputs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(b), **TOL_OP,
                                   err_msg=name)


def test_ms_deform_attn_taps_gradients_match_jax():
    """The whole tap op (two levels, f 1 and 2) differentiated through
    value, sampling locations and weights on both sides."""
    rng = np.random.RandomState(3)
    levels, (Hq, Wq), M, D, P, r = [(8, 16), (4, 8)], (8, 16), 2, 4, 2, 3
    value = rng.randn(2, sum(h * w for h, w in levels), M, D).astype(np.float32)
    ry, rx = np.meshgrid((np.arange(Hq) + 0.5) / Hq, (np.arange(Wq) + 0.5) / Wq,
                         indexing="ij")
    ref = np.stack([rx.reshape(-1), ry.reshape(-1)], -1)
    norm = np.array([[w, h] for h, w in levels], np.float64)
    offs = _off_kinks(rng.uniform(-2.5, 2.5, (2, Hq * Wq, M, 2, P, 2)))
    locs = (ref[None, :, None, None, None] + offs / norm[:, None]).astype(np.float32)
    w = rng.rand(2, Hq * Wq, M, 2, P).astype(np.float32)
    g = rng.randn(2, Hq * Wq, M * D).astype(np.float32)
    _, vjp = jax.vjp(lambda v, l, a: msda_jax.ms_deform_attn_taps(
        v, levels, l, a, (Hq, Wq), r), *(jnp.asarray(x) for x in (value, locs, w)))
    want = vjp(jnp.asarray(g))
    inputs = [_t(x).requires_grad_() for x in (value, locs, w)]
    msda.ms_deform_attn_taps(*inputs[:1], levels, *inputs[1:], (Hq, Wq), r) \
        .backward(_t(g))
    for name, x, b in zip(("value", "locations", "weights"), inputs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-5, err_msg=name)


def test_serving_calls_the_forward_alone(monkeypatch):
    """Without a gradient (inference mode, no_grad, or no input that needs
    one) the tap op does not go through the autograd function."""
    def refuse(*args):
        raise AssertionError("TapLevel used without a gradient")

    monkeypatch.setattr(msda.TapLevel, "apply", refuse)
    rng = np.random.RandomState(4)
    value = _t(rng.randn(1, 32, 2, 4).astype(np.float32))
    locs = _t(rng.rand(1, 32, 2, 1, 2, 2).astype(np.float32))
    w = _t(rng.rand(1, 32, 2, 1, 2).astype(np.float32))
    with torch.inference_mode():
        msda.ms_deform_attn_taps(value, [(4, 8)], locs, w, (4, 8), 2)
    with torch.no_grad():
        msda.ms_deform_attn_taps(value.requires_grad_(), [(4, 8)], locs, w,
                                 (4, 8), 2)


def test_cpu_bwd_wrapper_takes_the_plain_version_and_counts_no_launch():
    _native.reset_launch_counts()
    rng = np.random.RandomState(5)
    vmap, dx, dy, aw, g = (_t(x) for x in _case(rng, 2, 2))
    got = msda.msda_taps_bwd(vmap, dx, dy, aw, g, 2, 2)
    want = msda.msda_taps_bwd_plain(vmap, dx, dy, aw, g, 2, 2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert _native.launch_counts()["msda_taps_bwd"] == 0
    with pytest.raises(ValueError, match="g must be"):
        msda.msda_taps_bwd(vmap, dx, dy, aw, g[:, :4], 2, 2)
    with pytest.raises(TypeError, match="g must be"):
        msda.msda_taps_bwd(vmap, dx, dy, aw, g.double(), 2, 2)
    with pytest.raises(ValueError, match="whole"):
        msda.msda_taps_bwd(vmap[:, :, :5], dx, dy, aw, g, 2, 2)


# ---- a model of csrc/msda_taps_bwd.cu ---- #

WHOLE = (0, 0, None)  # (q0, v0, level rows): the whole map


def _base(q, f):
    return (2 * q + 1 + f) // (2 * f) - 1


def _first_query(b, f, n):
    """The .cu's first_query: the first q in [0, n] with base(q) >= b."""
    num = 2 * f * (b + 1) - 1 - f
    return torch.where(num <= 0, 0, torch.clamp((num + 1) // 2, max=n))


def _first_query_row(b, f, n, rows):
    """The .cu's first_query_row: the first local query row in [0, n] whose
    base cell is at least row b of the map (rows: q0, v0, level rows)."""
    q0, v0, _ = rows
    num = 2 * f * (b + v0 + 1) - 1 - f
    q = torch.where(num <= 0, 0, (num + 1) // 2)
    return torch.clamp(q - q0, 0, n)


def _row_frame(Hl, Hq, f, rows):
    """The local base row of each query row and the map's rows on the
    level, [ylo, yhi)."""
    q0, v0, Hg = rows
    Hg = Hl if Hg is None else Hg
    return (_base(torch.arange(Hq) + q0, f) - v0, max(0, -v0),
            min(Hl, Hg - v0))


def _hat_slope(z):
    return torch.where(z.abs() < 1, torch.where(z > 0, -1.0, torch.where(
        z < 0, 1.0, 0.0)), 0.0)


def _sample_model(v, dx, dy, aw, g, M, r, rows=WHOLE):
    """The sample kernel: per (query, head, point) its two corner rows and
    columns, each kept corner gathered and dotted with g."""
    B, Hl, Wl, MD = v.shape
    _, Hq, Wq, MP = dx.shape
    P, D, f = MP // M, MD // M, Wq // Wl
    shape = (B, Hq, Wq, M, P)
    dx5, dy5, aw5 = (t.reshape(shape) for t in (dx, dy, aw))
    g5 = g.reshape(B, Hq, Wq, M, 1, D)
    by, ylo, yhi = _row_frame(Hl, Hq, f, rows)
    by = by[None, :, None, None, None]
    bx = _base(torch.arange(Wq), f)[None, None, :, None, None]
    ok = (dx5.abs() <= r + 1) & (dy5.abs() <= r + 1)
    y0 = torch.where(ok, dy5, 0.0).floor().long()
    x0 = torch.where(ok, dx5, 0.0).floor().long()
    bi = torch.arange(B)[:, None, None, None, None]
    mi = torch.arange(M)[None, None, None, :, None]
    v5 = v.reshape(B, Hl, Wl, M, D)
    out = [torch.zeros(shape) for _ in range(3)]
    for i in range(2):
        for j in range(2):
            ty, tx = y0 + i, x0 + j
            ly, lx = by + ty, bx + tx
            keep = ok & (ty.abs() <= r) & (tx.abs() <= r) & (ly >= ylo) \
                & (ly < yhi) & (lx >= 0) & (lx < Wl)
            zy, zx = dy5 - ty, dx5 - tx
            hy, hx = (1 - zy.abs()).clamp_min(0), (1 - zx.abs()).clamp_min(0)
            corner = v5[bi, ly.clamp(0, Hl - 1), lx.clamp(0, Wl - 1), mi]
            s = torch.where(keep, (g5 * corner).sum(-1), 0.0)
            out[0] += hy * hx * s
            out[1] += aw5 * hx * _hat_slope(zy) * s
            out[2] += aw5 * hy * _hat_slope(zx) * s
    return [o.reshape(dx.shape) for o in (out[2], out[1], out[0])]


def _walk_model(dx, dy, aw, g, Hl, Wl, M, r, rows=WHOLE):
    """The walk kernel (r > 5): each level pixel walks the base cells
    within r of it, each cell's query range per axis from first_query, and
    takes the samples with a corner on the pixel."""
    B, Hq, Wq, MP = dx.shape
    MD = g.shape[-1]
    P, D, f = MP // M, MD // M, Wq // Wl
    dx5, dy5, aw5 = (t.reshape(B, Hq, Wq, M, P) for t in (dx, dy, aw))
    g5 = g.reshape(B, Hq, Wq, M, D)
    py = torch.arange(Hl)[:, None].expand(Hl, Wl)
    px = torch.arange(Wl)[None, :].expand(Hl, Wl)
    # a pixel off the level map (a tile's halo past the global edge) walks
    # no cell
    _, ylo, yhi = _row_frame(Hl, Hq, f, rows)
    on_map = ((py >= ylo) & (py < yhi))[None, :, :, None, None]
    acc = torch.zeros(B, Hl, Wl, M, D)
    for cy in range(2 * r + 1):
        by, ty = py - r + cy, r - cy
        qy0 = _first_query_row(by, f, Hq, rows)
        qy1 = _first_query_row(by + 1, f, Hq, rows)
        assert ((qy1 - qy0) <= f).all()
        for cx in range(2 * r + 1):
            bx, tx = px - r + cx, r - cx
            qx0, qx1 = _first_query(bx, f, Wq), _first_query(bx + 1, f, Wq)
            for ky in range(f):
                for kx in range(f):
                    qy, qx = qy0 + ky, qx0 + kx
                    valid = (qy < qy1) & (qx < qx1)
                    if not valid.any():
                        continue
                    qy, qx = qy.clamp(max=Hq - 1), qx.clamp(max=Wq - 1)
                    w = _pixel_weight(dx5, dy5, aw5, qy, qx, ty, tx, r)
                    w = torch.where(valid[None, :, :, None, None] & on_map,
                                    w, 0.0)
                    acc += w.sum(-1, keepdim=True) * g5[:, qy, qx]
    return acc.reshape(B, Hl, Wl, MD)


def _pixel_weight(dx5, dy5, aw5, qy, qx, ty, tx, r):
    """Per (image, pixel, head, point): the weight of query (qy, qx)'s
    sample on the pixel at tap (ty, tx) of its base cell (0 unless a corner
    of the sample is there), [B, Hl, Wl, M, P]."""
    sdx, sdy, saw = (t[:, qy, qx] for t in (dx5, dy5, aw5))
    ok = (sdx.abs() <= r + 1) & (sdy.abs() <= r + 1)
    y0 = torch.where(ok, sdy, 0.0).floor()
    x0 = torch.where(ok, sdx, 0.0).floor()
    hit = ok & ((y0 == ty) | (y0 + 1 == ty)) & ((x0 == tx) | (x0 + 1 == tx))
    hy = (1 - (sdy - ty).abs()).clamp_min(0)
    hx = (1 - (sdx - tx).abs()).clamp_min(0)
    return torch.where(hit, saw * hy * hx, 0.0)


def _tap_masks(dx, dy, Hl, Wl, M, r, rows=WHOLE):
    """The sample kernel's masks: [B, Hq, Wq, M, (2r+1)^2] bool, tap
    (ty + r)(2r + 1) + tx + r set for each kept corner of the (query,
    head)'s samples (within r + 1, |ty|, |tx| <= r, on the map)."""
    B, Hq, Wq, MP = dx.shape
    P, f, S = MP // M, Wq // Wl, 2 * r + 1
    dx5, dy5 = (t.reshape(B, Hq, Wq, M, P) for t in (dx, dy))
    by, ylo, yhi = _row_frame(Hl, Hq, f, rows)
    by = by[None, :, None, None, None]
    bx = _base(torch.arange(Wq), f)[None, None, :, None, None]
    ok = (dx5.abs() <= r + 1) & (dy5.abs() <= r + 1)
    y0 = torch.where(ok, dy5, 0.0).floor().long()
    x0 = torch.where(ok, dx5, 0.0).floor().long()
    masks = torch.zeros(B, Hq, Wq, M, S * S, dtype=torch.bool)
    for i in range(2):
        for j in range(2):
            ty, tx = y0 + i, x0 + j
            keep = ok & (ty.abs() <= r) & (tx.abs() <= r) & (by + ty >= ylo) \
                & (by + ty < yhi) & (bx + tx >= 0) & (bx + tx < Wl)
            t = torch.where(keep, (ty + r) * S + tx + r, 0)
            hot = F.one_hot(t, S * S).bool() & keep[..., None]  # [.., P, taps]
            masks |= hot.any(-2)
    return masks


def _cell_masks(qmask, Hl, Wl, rows=WHOLE):
    """The cell-mask kernel: per base cell (rows -oy .. Hc - oy - 1 of the
    map, the base cells of the query rows: -1 .. Hl - 1 on the whole map at
    f > 1; columns -ox .. Wl - 1, ox = 1 at f > 1) the OR of its queries'
    masks, [B, Hc, Wl + ox, M, taps]; at f 1 the query masks themselves
    (a cell is its query).  Returns the masks, oy and ox."""
    B, Hq, Wq = qmask.shape[:3]
    f = Wq // Wl
    base = _row_frame(Hl, Hq, f, rows)[0]
    oy, Hc = -int(base[0]), int(base[-1] - base[0]) + 1
    if f == 1:
        return qmask, oy, 0
    cells = torch.zeros(B, Hc, Wl + 1, *qmask.shape[3:], dtype=torch.bool)
    for cy in range(Hc):
        y0, y1 = (int(_first_query_row(torch.tensor(c), f, Hq, rows))
                  for c in (cy - oy, cy - oy + 1))
        for cx in range(Wl + 1):
            x0, x1 = (int(_first_query(torch.tensor(c), f, Wq)) for c in (cx - 1, cx))
            cells[:, cy, cx] = qmask[:, y0:y1, x0:x1].flatten(1, 2).any(1)
    return cells, oy, 1


def _gather_lanes(f):
    """The gather kernel's lanes per job: the largest power of two up to
    f^2 and 32."""
    lanes = 1
    while lanes < 32 and 2 * lanes <= f * f:
        lanes *= 2
    return lanes


def _gather_model(dx, dy, aw, g, Hl, Wl, M, r, rows=WHOLE):
    """The gather kernel (r <= 5, f <= 8): per (level pixel, head) the taps
    whose base cell's mask holds the pixel; L lanes split each kept cell's
    queries (slot j of the cell's f x f block, row j // f and column j % f,
    goes to lane j mod L, at most 2 a lane; a border cell's block holds
    fewer), at f > 1 each query's own mask bit is tested, a
    lane sums its hits slot by slot in tap order, and the lanes' sums meet
    in the xor butterfly.  Also returns the share of (pixel, head, tap)
    cells kept and of candidate queries loaded."""
    B, Hq, Wq, MP = dx.shape
    MD = g.shape[-1]
    P, D, f, S = MP // M, MD // M, Wq // Wl, 2 * r + 1
    qmask = _tap_masks(dx, dy, Hl, Wl, M, r, rows)
    cmask, oy, ox = _cell_masks(qmask, Hl, Wl, rows)
    Hc = cmask.shape[1]
    dx5, dy5, aw5 = (t.reshape(B, Hq, Wq, M, P) for t in (dx, dy, aw))
    g5 = g.reshape(B, Hq, Wq, M, D)
    L = _gather_lanes(f)
    py = torch.arange(Hl)[:, None].expand(Hl, Wl)
    px = torch.arange(Wl)[None, :].expand(Hl, Wl)
    acc = torch.zeros(L, B, Hl, Wl, M, D)
    bi = torch.arange(B)[:, None, None, None]
    mi = torch.arange(M)[None, None, None, :]
    kept_cells = loaded = candidates = 0
    slots = -(-f * f // L)
    assert slots <= 2  # the kernel's query slots a lane
    for k in range(slots):  # a lane's hits by slot, then in tap order
        for t in range(S * S):
            ty, tx = t // S - r, t % S - r
            by, bx = py - ty, px - tx
            inside = (by + oy >= 0) & (by + oy < Hc) & (bx + ox >= 0) & (bx < Wl)
            cy, cx = (by + oy).clamp(0, Hc - 1), (bx + ox).clamp(0, Wl + ox - 1)
            kept = inside[None, :, :, None] & cmask[bi, cy[..., None], cx[..., None], mi, t]
            kept_cells += int(kept.sum()) if k == 0 else 0
            qy0, qx0 = _first_query_row(by, f, Hq, rows), _first_query(bx, f, Wq)
            qy1 = _first_query_row(by + 1, f, Hq, rows)
            qx1 = _first_query(bx + 1, f, Wq)
            for lane in range(L):
                j = lane + k * L  # slot j: row j // f, column j % f of the block
                if j >= f * f:
                    continue
                qy, qx = qy0 + j // f, qx0 + j % f
                valid = (qy < qy1) & (qx < qx1)
                if not valid.any():
                    continue
                qy, qx = qy.clamp(max=Hq - 1), qx.clamp(max=Wq - 1)
                use = kept & valid[None, :, :, None]
                candidates += int(use.sum())
                if f > 1:
                    use &= qmask[bi, qy[..., None], qx[..., None], mi, t]
                loaded += int(use.sum())
                w = _pixel_weight(dx5, dy5, aw5, qy, qx, ty, tx, r)
                w = torch.where(use[..., None], w, 0.0)
                acc[lane] += w.sum(-1, keepdim=True) * g5[:, qy, qx]
    o_ = 1
    while o_ < L:  # lane l adds lane l ^ o_, for every lane at once
        acc = acc + acc[torch.arange(L) ^ o_]
        o_ <<= 1
    share = (kept_cells / (B * Hl * Wl * M * S * S),
             loaded / max(candidates, 1))
    return acc[0].reshape(B, Hl, Wl, MD), share


def _value_model(dx, dy, aw, g, Hl, Wl, M, r, rows=WHOLE):
    """The value path of ``csrc/msda_taps_bwd.cu``: the tap masks and the
    gather kernel up to r 5 and f 8, the walk kernel past them."""
    if r <= 5 and dx.shape[2] // Wl <= 8:  # kMaskRadius, kSlotsPerLane lanes
        return _gather_model(dx, dy, aw, g, Hl, Wl, M, r, rows)[0]
    return _walk_model(dx, dy, aw, g, Hl, Wl, M, r, rows)


@pytest.mark.parametrize("f,r,shape", [
    (1, 2, (9, 13, 3, 5, 3)),   # Hq, Wq, M, D, P: ragged everything
    (2, 5, (10, 14, 2, 4, 2)),
    (3, 2, (9, 12, 1, 3, 5)),
    (8, 5, (16, 24, 2, 8, 4)),  # the swin neck's D 8, P 4 at its coarsest level
    (2, 6, (10, 14, 2, 4, 2)),  # past the masks' 128 taps: the walk
])
def test_kernel_walk_model_matches_plain(f, r, shape):
    Hq, Wq, M, D, P = shape
    rng = np.random.RandomState(7 * f + r)
    v, dx, dy, aw, g = (_t(x) for x in _case(rng, f, r, Hq=Hq, Wq=Wq, M=M, D=D,
                                               P=P, whole=0.2))
    want = msda.msda_taps_bwd_plain(v, dx, dy, aw, g, M, r)
    got_dv = _value_model(dx, dy, aw, g, Hq // f, Wq // f, M, r)
    got = [got_dv] + _sample_model(v, dx, dy, aw, g, M, r)
    for name, a, b in zip(("dv", "ddx", "ddy", "daw"), got, want):
        torch.testing.assert_close(a, b, **TOL, msg=lambda m: f"{name}: {m}")
    # every term of d v was found: the walk covers each kept corner once
    assert want[0].abs().sum() > 0


@pytest.mark.parametrize("f", [1, 8])
def test_gather_model_skips_cells_and_queries_off_the_samples(f):
    """With displacements as the swin neck draws them (each head's P points
    within a pixel of one direction, up to 4 level pixels out), the cell
    masks keep a small share of the (pixel, head, tap) cells, and at f 8
    the query bits skip part of a kept cell's queries; d v still equals
    the plain version's."""
    r, M, P, D, Hq, Wq = 5, 8, 4, 8, 16, 24
    rng = np.random.RandomState(11 + f)
    angle = np.arange(M) * 2 * np.pi / M
    step = np.arange(1, P + 1)[None, :]
    base = np.stack([np.cos(angle)[:, None] * step, np.sin(angle)[:, None] * step])
    jitter = rng.uniform(-0.45, 0.45, (2, 2, Hq, Wq, M, P))
    dx, dy = (_off_kinks(base[k][None, None, None] + jitter[k]).reshape(2, Hq, Wq, M * P)
              for k in range(2))
    vmap, _, _, aw, g = _case(rng, f, r, Hq=Hq, Wq=Wq, M=M, D=D, P=P)
    v, dx, dy, aw, g = (_t(x) for x in (vmap, dx, dy, aw, g))
    got, (kept, loaded) = _gather_model(dx, dy, aw, g, Hq // f, Wq // f, M, r)
    want = msda.msda_taps_bwd_plain(v, dx, dy, aw, g, M, r)[0]
    torch.testing.assert_close(got, want, **TOL)
    assert kept < (0.2 if f == 1 else 0.5), kept
    if f > 1:
        assert loaded < 0.9, loaded


# ---- on an H tile ---- #

def tile_case(rng, f, r, q0, hq, margin, Hq=48, Wq=16, M=2, D=4, P=3):
    """A whole-map case and its H tile: query rows q0 .. q0 + hq - 1 and the
    map's rows the tile reads within r (``tap_value_rows``) plus ``margin``
    rows each side, the rows past the global edges zero, as the halo
    exchange gives them.  Returns (whole inputs, tile inputs, v0)."""
    whole = _case(rng, f, r, Hq=Hq, Wq=Wq, M=M, D=D, P=P, whole=0.2)
    vmap, dx, dy, aw, g = whole
    Hl = Hq // f
    lo, hi = msda.tap_value_rows(hq, f, r, q0, Hl)
    v0, v1 = lo - margin, hi + margin
    padded = np.pad(vmap, ((0, 0), (margin, margin), (0, 0), (0, 0)))
    local = padded[:, v0 + margin:v1 + margin]
    tile = (local,) + tuple(x[:, q0:q0 + hq] for x in (dx, dy, aw, g))
    return whole, tile, v0


TILE_CASES = [  # f, r, q0, hq, margin: the query tile and the map's halo
    (1, 2, 12, 12, 1),
    (2, 5, 24, 12, 1),
    (4, 5, 12, 12, 0),   # q0 a multiple of f
    (8, 5, 12, 12, 1),   # q0 not a multiple of f (the 1/32 level at 4 ranks)
    (8, 2, 36, 12, 0),   # the last tile, its map past the bottom edge
    (2, 6, 12, 12, 1),   # past the masks' 128 taps: the walk
    (1, 5, 0, 12, 3),    # the first tile, its map past the top edge
]


@pytest.mark.parametrize("f,r,q0,hq,margin", TILE_CASES)
def test_plain_bwd_at_an_offset_is_the_whole_map_cut_to_the_tile(f, r, q0, hq,
                                                                  margin):
    rng = np.random.RandomState(50 + 7 * f + r + q0)
    whole, tile, v0 = tile_case(rng, f, r, q0, hq, margin)
    Hl = whole[0].shape[1]
    g_whole = np.zeros_like(whole[4])
    g_whole[:, q0:q0 + hq] = tile[4]
    want = msda.msda_taps_bwd_plain(*(_t(x) for x in whole[:4]), _t(g_whole),
                                    2, r)
    got = msda.msda_taps_bwd_plain(*(_t(x) for x in tile), 2, r, q0, v0, Hl)
    for name, a, b in zip(("ddx", "ddy", "daw"), got[1:], want[1:]):
        torch.testing.assert_close(a, b[:, q0:q0 + hq], **TOL,
                                   msg=lambda m: f"{name}: {m}")
    n = tile[0].shape[1]
    rows = np.arange(v0, v0 + n)
    on = (rows >= 0) & (rows < Hl)
    torch.testing.assert_close(got[0][:, on], want[0][:, rows[on]], **TOL)
    assert (got[0][:, ~on] == 0).all()


@pytest.mark.parametrize("f,r,q0,hq,margin", TILE_CASES)
def test_kernel_model_at_an_offset_matches_plain(f, r, q0, hq, margin):
    rng = np.random.RandomState(90 + 7 * f + r + q0)
    whole, tile, v0 = tile_case(rng, f, r, q0, hq, margin)
    Hl = whole[0].shape[1]
    v, dx, dy, aw, g = (_t(x) for x in tile)
    rows = (q0, v0, Hl)
    want = msda.msda_taps_bwd_plain(v, dx, dy, aw, g, 2, r, *rows)
    got = [_value_model(dx, dy, aw, g, v.shape[1], v.shape[2], 2, r, rows)]
    got += _sample_model(v, dx, dy, aw, g, 2, r, rows)
    for name, a, b in zip(("dv", "ddx", "ddy", "daw"), got, want):
        torch.testing.assert_close(a, b, **TOL, msg=lambda m: f"{name}: {m}")
    # the kernel's scratch holds the model's masks
    base = _row_frame(v.shape[1], hq, f, rows)[0]
    cells = (int(base[-1] - base[0]) + 1) * (v.shape[2] + 1) if f > 1 else 0
    assert msda.msda_bwd_scratch_words(*v.shape[:3], hq, dx.shape[2], 2, q0,
                                       v0) == 2 * 2 * 4 * (hq * dx.shape[2] + cells)
