"""Multi-scale deformable attention (``nmrf_tpu/ops/msda.py``) and the
tap-MSDA kernel B5.

* ``ms_deform_attn``: the exact gather path (``TPU.MSDA_TAP_RADIUS 0``),
  bilinear sampling with zeros padding (``grid_sample`` semantics,
  align_corners=False) per level, weighted over the points.
* ``ms_deform_attn_taps``: the tap path, for queries on a regular grid over
  levels that are f times coarser (the swin DeformNeck's case).  Per level
  :func:`tap_level_inputs` gives every sample's displacement (dx, dy) in
  level pixels from its query's base cell, and :func:`msda_taps` sums the
  bilinear corners that lie within ``radius`` of that cell, dropping the
  rest.  It equals ``ms_deform_attn`` while every sample stays within the
  radius; :func:`tap_out_of_range_fraction` measures that precondition.
* ``msda_taps`` is the wrapper of kernel B5 (``csrc/msda_taps.cu``, which
  replaces ``nmrf_tpu/ops/pallas/msda.py:_msda_tap_kernel``): for CUDA
  tensors it launches the kernel or raises (``_native.launch``, which counts
  the launch and the variant that ran), through the registered operator
  ``nmrf::msda_taps`` (``ops/library.py``); for
  CPU tensors it takes ``msda_taps_plain``, the
  port's copy of the JAX package's dense (2r+1)^2-tap hat sum
  (``_tap_level_reference``).  The kernel gathers the 4 corners of each
  sample instead, so holding one against the other checks one formulation
  against the other.
* ``msda_taps_bwd`` is the wrapper of kernel B5b (``csrc/msda_taps_bwd.cu``),
  the backward of one level, in the same way: its plain version
  ``msda_taps_bwd_plain`` is the port's copy of the JAX package's manual,
  rematerializing backward (``nmrf_tpu/ops/msda.py:_tap_bwd``, a jnp scan
  over the taps, not a Pallas kernel).  :class:`TapLevel` joins the two
  into one autograd function, which ``ms_deform_attn_taps`` takes when a
  gradient is needed.
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import _native, library
from .constants import device_constant
from .sampling import grid_sample_2d


def ms_deform_attn(value, spatial_shapes, sampling_locations,
                   attention_weights):
    """Multi-scale deformable attention core (exact gather path).

    value: [B, S, M, D], S = sum of H_l * W_l; spatial_shapes: [(H_l, W_l)];
    sampling_locations: [B, Lq, M, L, P, 2] in [0, 1] (x, y);
    attention_weights: [B, Lq, M, L, P].  Returns [B, Lq, M*D].
    """
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    assert L == len(spatial_shapes)
    grids = 2.0 * sampling_locations - 1.0
    out = value.new_zeros((B, Lq, M, D))
    start = 0
    for lid, (H, W) in enumerate(spatial_shapes):
        v = value[:, start:start + H * W]
        start += H * W
        v = v.reshape(B, H, W, M, D).permute(0, 3, 1, 2, 4).reshape(B * M, H, W, D)
        g = grids[:, :, :, lid].permute(0, 2, 1, 3, 4).reshape(B * M, Lq, P, 2)
        sampled = grid_sample_2d(v, g)  # [B*M, Lq, P, D]
        w = attention_weights[:, :, :, lid].permute(0, 2, 1, 3).reshape(B * M, Lq, P)
        out = out + (sampled * w[..., None]).sum(2).reshape(B, M, Lq, D) \
            .permute(0, 2, 1, 3)
    return out.reshape(B, Lq, M * D)


def base_plus_one(n, f, q0=0):
    """base(q) + 1 = floor((2q + 1 + f) / (2f)) for q in [q0, q0 + n)
    (int32)."""
    q = np.arange(q0, q0 + n, dtype=np.int64)
    return ((2 * q + 1 + f) // (2 * f)).astype(np.int32)


def _base_cells(n, f, q0):
    return base_plus_one(n, f, q0) - 1


def tap_level_inputs(locations_l, weights_l, spatial_shape, query_shape,
                     q0=0):
    """Displacements in level pixels relative to each query's base cell.

    locations_l: [B, Lq, M, P, 2] (x, y in [0, 1]); weights_l: [B, Lq, M, P];
    spatial_shape: the level's (global) (Hl, Wl); query_shape: (Hq, Wq) of
    these queries, global rows q0 .. q0 + Hq - 1 of a query grid f = Wq / Wl
    times finer than the level.  The base cells are global, so the
    displacements are those of the whole grid.  Returns dx, dy, aw as
    [B, Hq, Wq, M*P] float32, in the JAX package's operation order.
    """
    Hl, Wl = spatial_shape
    Hq, Wq = query_shape
    B, Lq, M, P, _ = locations_l.shape
    f = Wq // Wl
    assert Wq == Wl * f and q0 + Hq <= Hl * f, (query_shape, q0, spatial_shape)
    dev = locations_l.device
    base_x = device_constant(_base_cells, (Wq, f, 0), dev, torch.float32)
    base_y = device_constant(_base_cells, (Hq, f, q0), dev, torch.float32)
    loc = locations_l.reshape(B, Hq, Wq, M * P, 2).float()
    dx = loc[..., 0] * Wl - 0.5 - base_x[None, None, :, None]
    dy = loc[..., 1] * Hl - 0.5 - base_y[None, :, None, None]
    aw = weights_l.reshape(B, Hq, Wq, M * P).float()
    return dx, dy, aw


def tap_value_rows(Hq, f, radius, q0=0, level_rows=None):
    """The global level rows [lo, hi) that queries q0 .. q0 + Hq - 1 read on
    the tap path: their base rows within ``radius``, on the level map
    (``level_rows`` rows, default Hq / f)."""
    base = base_plus_one(Hq, f, q0) - 1
    rows = Hq // f if level_rows is None else level_rows
    return (max(int(base[0]) - radius, 0),
            min(int(base[-1]) + radius + 1, rows))


def _halo_index_maps(Hq, Wq, f, r, q0=0, v0=0, Hl=None, Hg=None):
    """Row/column maps from the (r+1)-padded local level map vpad into the
    query-grid halo map U: U[j] = vpad[i[j]] along each axis, j in [0, n +
    2rf).  Row j is global level row base(j - rf + q0) of the local map
    whose row 0 is global row v0 (``Hl`` rows of the ``Hg`` of the level);
    a row off the level map reads vpad's first (zero) row."""
    Hl = Hq // f if Hl is None else Hl
    Hg = Hl if Hg is None else Hg
    jy = np.arange(Hq + 2 * r * f, dtype=np.int64) - r * f + q0
    gy = (2 * jy + 1 + f) // (2 * f) - 1
    ly = gy - v0
    iy = np.where((gy >= 0) & (gy < Hg) & (ly >= 0) & (ly < Hl),
                  ly + r + 1, 0).astype(np.int64)
    jx = np.arange(Wq + 2 * r * f, dtype=np.int64) - r * f
    ix = ((2 * jx + 1 + f) // (2 * f)).astype(np.int64) + r
    return iy, ix


def _halo_map(value_map, f, r, Hq, q0=0, v0=0, Hg=None):
    """The halo map U [B, Hq + 2rf, Wq + 2rf, MD]: U[y + (ty+r)f,
    x + (tx+r)f] is level pixel base(y) + ty, base(x) + tx (zero off the
    level map)."""
    B, Hl, Wl, MD = value_map.shape
    vpad = F.pad(value_map, (0, 0, r + 1, r + 1, r + 1, r + 1))
    args = (Hq, Wl * f, f, r, q0, v0, Hl, Hg)
    dev = value_map.device
    iy = device_constant(_halo_index_map, (0, *args), dev)
    ix = device_constant(_halo_index_map, (1, *args), dev)
    return vpad[:, iy][:, :, ix]


def _halo_index_map(axis, *args):
    return _halo_index_maps(*args)[axis]


def _msda_shapes(value_map, dx, dy, aw, num_heads, radius, q0=0, v0=0,
                 level_rows=None):
    """Checks; returns (B, Hl, Wl, MD, Hq, Wq, MP, f, Hg)."""
    for name, t in (("value_map", value_map), ("dx", dx), ("dy", dy), ("aw", aw)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-dim tensor")
    if value_map.dtype not in _native.DTYPE_CODES:
        raise TypeError(f"value_map must be float32 or bfloat16, got {value_map.dtype}")
    if any(t.dtype != torch.float32 for t in (dx, dy, aw)):
        raise TypeError("dx, dy and aw must be float32")
    if dy.shape != dx.shape or aw.shape != dx.shape:
        raise ValueError("dx, dy and aw must have one shape")
    B, Hl, Wl, MD = value_map.shape
    Bq, Hq, Wq, MP = dx.shape
    f = Wq // Wl if Wl else 0
    Hg = Hl if level_rows is None else int(level_rows)
    whole = q0 == 0 and v0 == 0 and level_rows is None
    if Bq != B or f < 1 or Wq != Wl * f or (whole and Hq != Hl * f) \
            or q0 < 0 or q0 + Hq > Hg * f:
        raise ValueError(f"query grid {tuple(dx.shape[:3])} at row {q0} is not "
                         f"a tile of a whole multiple of level map "
                         f"{tuple(value_map.shape[:3])} ({Hg} rows)")
    if not whole:
        lo, hi = tap_value_rows(Hq, f, int(radius), q0, Hg)
        if lo < v0 or hi > v0 + Hl:
            raise ValueError(f"level rows {v0} .. {v0 + Hl - 1} do not hold "
                             f"rows {lo} .. {hi - 1}, which queries {q0} .. "
                             f"{q0 + Hq - 1} read within radius {radius}")
    if MD % num_heads or MP % num_heads:
        raise ValueError(f"channels {MD} / points {MP} not divisible by "
                         f"{num_heads} heads")
    return B, Hl, Wl, MD, Hq, Wq, MP, f, Hg


def msda_taps_plain(value_map, dx, dy, aw, num_heads, radius, q0=0, v0=0,
                    level_rows=None):
    """Plain PyTorch version of :func:`msda_taps`: the dense hat sum over
    the (2r+1)^2 integer taps around each base cell (f32 math)."""
    B, Hl, Wl, MD, Hq, Wq, MP, f, Hg = _msda_shapes(
        value_map, dx, dy, aw, num_heads, radius, q0, v0, level_rows)
    M = num_heads
    P, D = MP // M, MD // M
    r = int(radius)
    taps = 2 * r + 1
    U = _halo_map(value_map, f, r, Hq, q0, v0, Hg)
    dx5 = dx.reshape(B, Hq, Wq, M, P)
    dy5 = dy.reshape(B, Hq, Wq, M, P)
    aw5 = aw.reshape(B, Hq, Wq, M, P)
    acc = torch.zeros((B, Hq, Wq, M, D), dtype=torch.float32, device=dx.device)
    for t in range(taps * taps):
        ty, tx = t // taps - r, t % taps - r
        hy = (1.0 - (dy5 - ty).abs()).clamp_min(0.0)
        hx = (1.0 - (dx5 - tx).abs()).clamp_min(0.0)
        w = (aw5 * hy * hx).sum(-1)  # [B, Hq, Wq, M]
        y0, x0 = (ty + r) * f, (tx + r) * f
        u = U[:, y0:y0 + Hq, x0:x0 + Wq].reshape(B, Hq, Wq, M, D).float()
        acc = acc + w[..., None] * u
    return acc.reshape(B, Hq, Wq, MD).to(value_map.dtype)


def msda_taps(value_map, dx, dy, aw, num_heads, radius, q0=0, v0=0,
              level_rows=None):
    """One level of tap-based MSDA.

    value_map: [B, Hl, Wl, M*D] level map (f32 or bf16), channels in
      (head, channel) order; dx, dy, aw: [B, Hq, Wq, M*P] float32 sample
      displacements from the base cell (level pixels) and attention
      weights, points in (head, point) order; Hq = f*Hl and Wq = f*Wl.
    Every bilinear corner more than ``radius`` level pixels from the base
    cell along either axis is dropped.  Returns [B, Hq, Wq, M*D] in
    value_map's dtype, summed in f32.  Not differentiable itself:
    :class:`TapLevel` is its autograd function.  On CUDA tensors B5 runs as
    the operator ``nmrf::msda_taps``.

    On an H tile (``models/adaptor.py`` under a spatial group): the queries
    are global rows q0 .. q0 + Hq - 1 of the grid (Wq = f*Wl still), the
    value map holds global level rows v0 .. v0 + Hl - 1 of the level's
    ``level_rows``, at least those the queries read within ``radius``
    (:func:`tap_value_rows`); base cells and the map's edges are global.
    """
    B, Hl, Wl, MD, Hq, Wq, MP, f, Hg = _msda_shapes(
        value_map, dx, dy, aw, num_heads, radius, q0, v0, level_rows)
    tensors = (value_map, dx, dy, aw)
    if all(t.device.type == "cpu" for t in tensors):
        return msda_taps_plain(value_map, dx, dy, aw, num_heads, radius, q0,
                               v0, level_rows)
    dev = value_map.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("msda_taps: inputs must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("msda_taps: inputs must be contiguous")
    if MD > 1024 or 3 * max(1, 256 // MD) * MP * 4 > 48 * 1024:
        raise ValueError(f"msda_taps kernel takes at most 1024 channels and "
                         f"a few thousand points per query, got {MD}, {MP}")
    return msda_taps_op(value_map, dx, dy, aw, num_heads, radius, q0, v0, Hg)


def _msda_taps_launch(value_map, dx, dy, aw, num_heads, radius, q0=0, v0=0,
                      level_rows=-1):
    """One B5 launch on inputs that :func:`msda_taps` has checked
    (``level_rows`` -1: the map's own rows)."""
    B, Hl, Wl, MD = value_map.shape
    Hq, Wq, MP = dx.shape[1:]
    out = torch.empty((B, Hq, Wq, MD), dtype=value_map.dtype,
                      device=value_map.device)
    if out.numel() == 0:
        return out
    M = num_heads
    _native.launch(
        "msda_taps", value_map.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        aw.data_ptr(), out.data_ptr(), _native.DTYPE_CODES[value_map.dtype],
        B, Hl, Wl, Hq, Wq, M, MD // M, MP // M, int(radius), int(q0), int(v0),
        Hl if level_rows < 0 else int(level_rows), variants=MSDA_VARIANTS)
    return out


def _msda_taps_fake(value_map, dx, dy, aw, num_heads, radius, q0=0, v0=0,
                    level_rows=-1):
    return value_map.new_empty(tuple(dx.shape[:3]) + (value_map.shape[3],))


# B5 as the registered operator nmrf::msda_taps (``ops/library.py``)
msda_taps_op = library.define(
    "msda_taps(Tensor value_map, Tensor dx, Tensor dy, Tensor aw, "
    "int num_heads, int radius, int q0=0, int v0=0, int level_rows=-1) "
    "-> Tensor",
    _msda_taps_launch, _msda_taps_fake)

# B5's and B5b's kernels by the code their entries report
# (csrc/msda_taps.cu, csrc/msda_taps_bwd.cu: bit 0 the vector path, bit 1
# B5b's tap masks)
MSDA_VARIANTS = {1: "vector", 0: "scalar"}
MSDA_BWD_VARIANTS = {3: "vector_masks", 2: "scalar_masks", 1: "vector_walk",
                     0: "scalar_walk"}


def msda_bwd_scratch_words(B, Hl, Wl, Hq, Wq, M, q0=0, v0=0):
    """The int32 words of scratch B5b is given: the most its tap masks take
    (``mask_words`` of ``csrc/msda_taps_bwd.cu``), 4 per (query, head) for
    the query masks and, at a level factor above 1, 4 per (base cell,
    head) for the cell masks: the base cells of the queries' rows (-1 ..
    Hl - 1 on the whole map) by columns -1 .. Wl - 1.  The kernel alone
    chooses between the masks and its walk, which takes none."""
    f = Wq // Wl
    base = base_plus_one(Hq, f, q0)
    cells = (int(base[-1] - base[0]) + 1) * (Wl + 1) if f > 1 else 0
    return B * M * 4 * (Hq * Wq + cells)


def msda_taps_bwd_plain(value_map, dx, dy, aw, g, num_heads, radius, q0=0,
                        v0=0, level_rows=None):
    """Plain PyTorch version of :func:`msda_taps_bwd`: the JAX package's
    manual backward ``_tap_bwd``, a loop over the (2r+1)^2 taps that keeps
    only the gradient accumulators and recomputes each tap's hat weights,
    then the halo map's gather transposed by two index sums.  At a hat kink
    it takes ``_tap_bwd``'s choice: a tap's hat derivative is -sign(z) where
    |z| < 1 and 0 elsewhere, so 0 at z = 0 and at |z| = 1."""
    B, Hl, Wl, MD, Hq, Wq, MP, f, Hg = _msda_shapes(
        value_map, dx, dy, aw, num_heads, radius, q0, v0, level_rows)
    M = num_heads
    P, D = MP // M, MD // M
    r = int(radius)
    taps = 2 * r + 1
    U = _halo_map(value_map, f, r, Hq, q0, v0, Hg).float()
    g5 = g.reshape(B, Hq, Wq, M, D).float()
    dx5 = dx.reshape(B, Hq, Wq, M, P)
    dy5 = dy.reshape(B, Hq, Wq, M, P)
    aw5 = aw.reshape(B, Hq, Wq, M, P)
    ddx = torch.zeros_like(dx5)
    ddy = torch.zeros_like(dx5)
    daw = torch.zeros_like(dx5)
    dU = torch.zeros_like(U)
    for t in range(taps * taps):
        ty, tx = t // taps - r, t % taps - r
        zy, zx = dy5 - ty, dx5 - tx
        hy = (1.0 - zy.abs()).clamp_min(0.0)
        hx = (1.0 - zx.abs()).clamp_min(0.0)
        y0, x0 = (ty + r) * f, (tx + r) * f
        u5 = U[:, y0:y0 + Hq, x0:x0 + Wq].reshape(g5.shape)
        s = (g5 * u5).sum(-1, keepdim=True)
        daw = daw + hy * hx * s
        gy = torch.where(zy.abs() < 1.0, -torch.sign(zy), 0.0)
        gx = torch.where(zx.abs() < 1.0, -torch.sign(zx), 0.0)
        ddy = ddy + aw5 * hx * gy * s
        ddx = ddx + aw5 * hy * gx * s
        w = (aw5 * hy * hx).sum(-1)
        dU[:, y0:y0 + Hq, x0:x0 + Wq] += (w[..., None] * g5).reshape(B, Hq, Wq, MD)
    # the halo gather transposed: dvpad[i] = sum of dU[j] over iy[j] = i
    iy, ix = _halo_index_maps(Hq, Wq, f, r, q0, v0, Hl, Hg)
    dev = value_map.device
    Hp, Wp = Hl + 2 * (r + 1), Wl + 2 * (r + 1)
    rows = dU.new_zeros((B, Hp, dU.shape[2], MD)).index_add_(
        1, torch.as_tensor(iy, device=dev), dU)
    dvpad = dU.new_zeros((B, Hp, Wp, MD)).index_add_(
        2, torch.as_tensor(ix, device=dev), rows)
    dvalue = dvpad[:, r + 1:r + 1 + Hl, r + 1:r + 1 + Wl].to(value_map.dtype)
    return (dvalue, ddx.reshape(dx.shape), ddy.reshape(dy.shape),
            daw.reshape(aw.shape))


def msda_taps_bwd(value_map, dx, dy, aw, g, num_heads, radius, q0=0, v0=0,
                  level_rows=None):
    """Backward of :func:`msda_taps` for one level (kernel B5b).

    value_map, dx, dy, aw: the forward's inputs; g: [B, Hq, Wq, M*D], the
    gradient of its output, in value_map's dtype.  Returns (d value_map in
    its dtype, d dx, d dy, d aw in float32), summed in f32, with the
    forward's rules: a corner more than ``radius`` level pixels from the
    base cell, or past the map, adds nothing to any of them.  For CUDA
    tensors it launches the kernel or raises (``_native.launch``, which
    counts the launches and the variant the entry reports,
    ``MSDA_BWD_VARIANTS``: the vector or scalar path, the tap masks up to r
    5 and f 8, else the walk); for
    CPU tensors it takes :func:`msda_taps_bwd_plain`.  ``q0``, ``v0`` and
    ``level_rows`` place the queries and the map on an H tile, as for
    :func:`msda_taps`; d value_map holds the gradient of the map's rows.
    """
    B, Hl, Wl, MD, Hq, Wq, MP, f, Hg = _msda_shapes(
        value_map, dx, dy, aw, num_heads, radius, q0, v0, level_rows)
    if not isinstance(g, torch.Tensor) or g.shape != (B, Hq, Wq, MD):
        raise ValueError(f"g must be a [{B}, {Hq}, {Wq}, {MD}] tensor")
    if g.dtype != value_map.dtype:
        raise TypeError(f"g must be {value_map.dtype}, got {g.dtype}")
    tensors = (value_map, dx, dy, aw, g)
    if all(t.device.type == "cpu" for t in tensors):
        return msda_taps_bwd_plain(value_map, dx, dy, aw, g, num_heads, radius,
                                   q0, v0, level_rows)
    dev = value_map.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("msda_taps_bwd: inputs must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("msda_taps_bwd: inputs must be contiguous")
    dvalue = torch.empty_like(value_map)
    ddx, ddy, daw = (torch.empty_like(dx) for _ in range(3))
    if dx.numel() == 0:
        return dvalue.zero_(), ddx, ddy, daw
    M = num_heads
    scratch = torch.empty(
        msda_bwd_scratch_words(B, Hl, Wl, Hq, Wq, M, q0, v0),
        dtype=torch.int32, device=dev)
    _native.launch(
        "msda_taps_bwd", value_map.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        aw.data_ptr(), g.data_ptr(), dvalue.data_ptr(), ddx.data_ptr(),
        ddy.data_ptr(), daw.data_ptr(), scratch.data_ptr(),
        4 * scratch.numel(), _native.DTYPE_CODES[value_map.dtype], B, Hl, Wl,
        Hq, Wq, M, MD // M, MP // M, int(radius), int(q0), int(v0), Hg,
        variants=MSDA_BWD_VARIANTS)
    return dvalue, ddx, ddy, daw


class TapLevel(torch.autograd.Function):
    """One level of the tap path as an autograd function (the JAX
    package's ``_tap_level_op`` custom VJP): the forward is
    :func:`msda_taps`, the backward :func:`msda_taps_bwd` (their plain
    versions with ``use_kernels`` False).  It saves only its four inputs
    and recomputes the rest in the backward.  ``rows`` (q0, v0,
    level_rows) places it on an H tile (:func:`msda_taps`)."""

    @staticmethod
    def forward(ctx, value_map, dx, dy, aw, num_heads, radius, use_kernels,
                rows=()):
        ctx.save_for_backward(value_map, dx, dy, aw)
        ctx.num_heads, ctx.radius, ctx.use_kernels = num_heads, radius, use_kernels
        ctx.rows = rows
        level = msda_taps if use_kernels else msda_taps_plain
        return level(value_map, dx, dy, aw, num_heads, radius, *rows)

    @staticmethod
    def backward(ctx, g):
        value_map = ctx.saved_tensors[0]
        bwd = msda_taps_bwd if ctx.use_kernels else msda_taps_bwd_plain
        grads = bwd(*ctx.saved_tensors, g.to(value_map.dtype).contiguous(),
                    ctx.num_heads, ctx.radius, *ctx.rows)
        return (*grads, None, None, None, None)


def ms_deform_attn_taps(value, spatial_shapes, sampling_locations,
                        attention_weights, query_shape, radius,
                        use_kernels=True, q0=0, value_rows=None):
    """Tap-based MSDA for grid-aligned queries: the contract of
    :func:`ms_deform_attn` plus the query grid (Hq, Wq), Lq = Hq * Wq.
    Exact while every sample lies within ``radius`` level pixels of its
    query's base cell per axis; contributions beyond it are dropped.
    ``use_kernels`` False takes the plain versions on every device.  When a
    gradient is needed each level goes through :class:`TapLevel`; without
    one (serving, ``torch.no_grad``) it calls the forward alone.

    On an H tile: the queries are global rows q0 .. q0 + Hq - 1, and
    ``value_rows`` gives each level's (v0, n): its n rows in ``value`` are
    the global rows from v0 (the whole level by default); spatial_shapes
    stay the global levels'."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    Hq, Wq = query_shape
    assert Lq == Hq * Wq
    if value_rows is None:
        value_rows = [(0, Hl) for Hl, _ in spatial_shapes]
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (value, sampling_locations, attention_weights))
    out = None
    start = 0
    for lid, ((Hl, Wl), (v0, n)) in enumerate(zip(spatial_shapes, value_rows)):
        vmap = value[:, start:start + n * Wl].reshape(B, n, Wl, M * D)
        start += n * Wl
        dx, dy, aw = tap_level_inputs(sampling_locations[:, :, :, lid],
                                      attention_weights[:, :, :, lid],
                                      (Hl, Wl), query_shape, q0)
        whole = (q0, v0, n) == (0, 0, Hl) and Hq * Wl == Hl * Wq
        rows = () if whole else (q0, v0, Hl)
        if grad:
            o = TapLevel.apply(vmap.contiguous(), dx, dy, aw, M, radius,
                               use_kernels, rows)
        else:
            level = msda_taps if use_kernels else msda_taps_plain
            o = level(vmap.contiguous(), dx, dy, aw, M, radius, *rows)
        out = o if out is None else out + o
    return out.reshape(B, Lq, M * D).to(value.dtype)


def tap_out_of_range_fractions(sampling_locations, spatial_shapes,
                               query_shape, radius, q0=0):
    """Per level, the share of the sampling points whose displacement from
    their query's base cell exceeds ``radius`` along either axis, i.e.
    whose contribution the tap path drops: a [L] float32 tensor, each a
    mean over the batch, so that equal data shards' values average to the
    whole batch's (and equal H tiles' to the whole grid's: ``q0`` places
    the queries on a tile, as for :func:`ms_deform_attn_taps`)."""
    fracs = []
    for lid, (Hl, Wl) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lid]
        dx, dy, _ = tap_level_inputs(loc, torch.zeros_like(loc[..., 0]),
                                     (Hl, Wl), query_shape, q0)
        oob = (dx.abs() > radius) | (dy.abs() > radius)
        fracs.append(oob.float().mean())
    return torch.stack(fracs)


def tap_out_of_range_fraction(sampling_locations, spatial_shapes, query_shape,
                              radius):
    """The largest of :func:`tap_out_of_range_fractions` over the levels.
    0.0 means the tap path is exact for these inputs."""
    return tap_out_of_range_fractions(sampling_locations, spatial_shapes,
                                      query_shape, radius).max()
