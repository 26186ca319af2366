"""NMP attention kernels: window attention (K1) and stripe attention (K2),
their backwards (K1b, K2b), the fully fused window backward (B7), and
rectangular masked attention (B6) with its backward (B6b).

Each function here has three parts:

* the wrapper (``window_attention``, ``stripe_attention`` and the backward
  wrappers ``window_attention_bwd``, ``window_attention_pos_bwd``,
  ``stripe_attention_bwd``), which checks its inputs and, for CUDA
  tensors, launches the hand-written kernel from
  ``nmrf_tpu_torch/csrc`` on the current stream, raising if the launch
  fails, through ``_native.launch``, which counts the launches by kernel
  name (``_native.launch_counts``; K1's also by the kernel its entry
  chose, ``_native.variant_counts``);
* the plain PyTorch version (``*_plain``) of the same function.  The wrapper
  takes it only for tensors on the CPU; the tests and ``chip_smoke.py``
  hold the kernel against it.  The plain backward versions write the
  softmax backward out by hand, as the TPU kernels do;
* the source note in the ``.cu`` file: which TPU kernel it replaces, what
  bounds it on the H100 and what its design does about that.

K1 and K2 are also the registered operators ``nmrf::window_attention`` and
``nmrf::stripe_attention`` (``ops/library.py``): their CUDA implementation
is the launch function, their fake implementation gives the output's shape
and dtype, so an exported forward (``utils/export.py``) holds one graph
node per launch.  The wrappers call the operator on CUDA tensors, inside
their autograd function where a gradient is recorded.

K1 replaces ``nmrf_tpu/ops/pallas/attention.py:_window_native_kernel_direct``
(and the transposed ``_window_native_kernel``, the same function), K2
``_stripe_attention_kernel``, K1b ``_wan_bwd_kernel_direct``, K2b
``_stripe_bwd_kernel``, B6 ``_masked_attention_kernel``, B6b
``_masked_attention_bwd_kernel`` and B7 ``_wan_bwd_fused_pos_kernel``.  On
CUDA tensors the forward wrappers are ``torch.autograd.Function``s whose
backward is K1b, K2b or B6b; on the CPU autograd differentiates the plain
forward versions.  ``window_attention(..., fused_pos=True)`` (the JAX
package's ``NMRF_FUSED_POS=1`` path) takes B7 as the backward instead of
K1b, and on the CPU B7's plain version, so the CPU tests run it inside the
model.
"""

from functools import lru_cache

import numpy as np
import torch

from . import _native, library
from .constants import device_constant

NEG_INF = -1e9  # finite -inf stand-in, softmax-safe
_DTYPE_CODES = _native.DTYPE_CODES
_KERNEL_HEAD_DIMS = (16, 32, 64)
# K1's kernels by the code its entry reports (csrc/window_attention.cu)
WINDOW_VARIANTS = {1: "mma", 0: "cuda_core"}
# blocks of B7's main kernel over all heads: each writes one partial of the
# table cotangent, so the count is a function of the shapes only (the sum
# over partials then has one order on every card); two waves of one block
# per SM on the H100's 132 SMs at the Inference window
_POS_BWD_BLOCKS = 264
# blocks of K1b's d(ve) partial kernel, about 8 per SM on the H100's 132:
# the split of its items is a function of the shapes only, so the partials
# are summed in one order on every card
_DVE_BLOCKS = 1056


def _dve_splits(items, P, heads):
    """Splits of K1b's d(ve) reduction over its items (window, candidate),
    at least 32 items each."""
    return max(1, min(-(-_DVE_BLOCKS // (P * heads)), -(-items // 32)))


@lru_cache(maxsize=16)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """[P, P] row of the relative-position table for (query pixel, key pixel)
    of a wh x ww window (reference ``NMP.py``; ``nmp.py:383``)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def _check_tensor(name, t, ndim):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")


# --------------------------------------------------------------------------- #
# K1 / K1b: shifted-window attention with relative-position terms
# --------------------------------------------------------------------------- #

@lru_cache(maxsize=32)
def _window_mask(Hp, Wp, wh, ww, N, shift, candidate_mask, row0=0,
                 hp_total=None):
    """[nwh*nww, T, T] additive mask of every window, from token coordinates
    (candidate mask and shifted-region mask, as the kernel builds them).
    Under H-sharding the image is one tile of a taller one: the region rows
    are global, y = row0 + local y against the global padded height
    ``hp_total`` (``nmrf_tpu/ops/pallas/attention.py:_shifted_region_mask``);
    row0 = 0 and hp_total = Hp for a whole image."""
    hp_total = Hp if hp_total is None else hp_total
    P = wh * ww
    t = np.arange(P * N)
    pix = t // N
    mask = np.zeros((Hp // wh, Wp // ww, P * N, P * N), np.float32)
    if candidate_mask:
        same = (pix[:, None] == pix[None, :]) & (t[:, None] != t[None, :])
        mask += np.where(same, NEG_INF, 0.0).astype(np.float32)
    if shift > 0:
        y = row0 + np.arange(Hp // wh)[:, None] * wh + (pix // ww)[None, :]
        x = np.arange(Wp // ww)[:, None] * ww + (pix % ww)[None, :]
        ry = (y >= hp_total - wh).astype(int) + (y >= hp_total - shift)
        rx = (x >= Wp - ww).astype(int) + (x >= Wp - shift)
        reg = 3 * ry[:, None, :] + rx[None, :, :]          # [nwh, nww, T]
        diff = reg[..., :, None] != reg[..., None, :]
        mask += np.where(diff, NEG_INF, 0.0).astype(np.float32)
    return mask.reshape(-1, P * N, P * N)


def _window_shapes(qkv, rel_table, window, num_heads, row0=0, hp_total=None):
    _check_tensor("qkv", qkv, 5)
    B, Hp, Wp, N, C3 = qkv.shape
    wh, ww = window
    if hp_total is not None and not 0 <= row0 <= hp_total - Hp:
        raise ValueError(f"rows {row0}..{row0 + Hp} of the tile outside the "
                         f"global padded height {hp_total}")
    if C3 % (3 * num_heads):
        raise ValueError(f"qkv channels {C3} not divisible by 3*{num_heads}")
    if Hp % wh or Wp % ww:
        raise ValueError(f"padded size {Hp}x{Wp} not a multiple of {wh}x{ww}")
    C = C3 // 3
    if tuple(rel_table.shape) != ((2 * wh - 1) * (2 * ww - 1), C3):
        raise ValueError(f"rel_table shape {tuple(rel_table.shape)} does not "
                         f"match window {window} and 3C = {C3}")
    return B, Hp, Wp, N, C


def _window_split(x, window, num_heads, comps):
    """[B, Hp, Wp, N, comps*h*hd] -> [comps, G, h, T, hd] f32, windows in
    (b, row, col) order and tokens in (pixel row, pixel col, n) order."""
    B, Hp, Wp, N, CC = x.shape
    wh, ww = window
    hd = CC // (comps * num_heads)
    x = x.float().reshape(B, Hp // wh, wh, Wp // ww, ww, N, comps, num_heads, hd)
    x = x.permute(6, 0, 1, 3, 7, 2, 4, 5, 8)
    return x.reshape(comps, -1, num_heads, wh * ww * N, hd)


def _window_merge(x, shape, window):
    """Inverse of :func:`_window_split`: [comps, G, h, T, hd] ->
    [B, Hp, Wp, N, comps*h*hd]."""
    B, Hp, Wp, N = shape
    comps, _, h, _, hd = x.shape
    wh, ww = window
    x = x.reshape(comps, B, Hp // wh, Wp // ww, h, wh, ww, N, hd)
    return x.permute(1, 2, 5, 3, 6, 7, 0, 4, 8).reshape(B, Hp, Wp, N,
                                                        comps * h * hd)


def _window_index(window, device):
    return device_constant(relative_position_index, tuple(window),
                           device).reshape(-1)


@lru_cache(maxsize=16)
def _window_scatter_index(wh: int, ww: int) -> np.ndarray:
    """[(2wh-1)(2ww-1), P] for each table row, the (p, s) pairs (index p P +
    s) at that relative position, padded with P*P (the index of an
    appended zero row).  The table cotangent is then a gather and a sum in
    one fixed order: ``index_add_`` on a card adds with atomics in an order
    that changes from run to run."""
    idx = relative_position_index(wh, ww).reshape(-1)
    out = np.full(((2 * wh - 1) * (2 * ww - 1), wh * ww), idx.size, np.int64)
    fill = np.zeros(len(out), np.int64)
    for pair, t in enumerate(idx):
        out[t, fill[t]] = pair
        fill[t] += 1
    return out


def _window_tables(table, window, num_heads):
    """(qe, ke, ve), each [P, P, h, hd]: the table rows rel(p, s) of query
    pixel p and key pixel s, columns in (head, component, hd) order."""
    P = window[0] * window[1]
    rpe = table[_window_index(window, table.device)]
    rpe = rpe.reshape(P, P, num_heads, 3, -1)
    return rpe[..., 0, :], rpe[..., 1, :], rpe[..., 2, :]


def _window_probs(q, k, qe, ke, shape, window, shift, candidate_mask, row0,
                  hp_total):
    """Softmax of the logits [G, h, T, T]: scaled q.k, the positional terms
    qr[i, pix(j)] + kr[j, pix(i)] and the masks."""
    B, Hp, Wp, N = shape
    G, h, T, hd = q.shape
    P = T // N
    scale = hd ** -0.5
    logits = torch.einsum("ghic,ghjc->ghij", q, k) * scale
    q5 = q.reshape(G, h, P, N, hd)
    k5 = k.reshape(G, h, P, N, hd)
    qr = torch.einsum("ghpnc,pshc->ghpns", q5, ke) * scale
    kr = torch.einsum("ghsmc,pshc->ghpsm", k5, qe) * scale
    logits = logits.reshape(G, h, P, N, P, N) + qr[..., None] + kr[:, :, :, None]
    mask = device_constant(
        _window_mask, (Hp, Wp, *window, N, int(shift), bool(candidate_mask),
                       int(row0), None if hp_total is None else int(hp_total)),
        q.device)
    logits = logits.reshape(B, -1, h, T, T) + mask[None, :, None]
    return torch.softmax(logits.reshape(G, h, T, T), dim=-1)


def window_attention_plain(qkv, rel_table, shift, window, num_heads,
                           candidate_mask, row0=0, hp_total=None):
    """Plain PyTorch version of :func:`window_attention` (f32 math)."""
    B, Hp, Wp, N, C = _window_shapes(qkv, rel_table, window, num_heads, row0,
                                     hp_total)
    q, k, v = _window_split(qkv, window, num_heads, 3)
    qe, ke, ve = _window_tables(rel_table.to(qkv.dtype).float(), window,
                                num_heads)
    attn = _window_probs(q, k, qe, ke, (B, Hp, Wp, N), window, shift,
                         candidate_mask, row0, hp_total)
    G, h, T, hd = q.shape
    P = T // N
    out = torch.einsum("ghij,ghjc->ghic", attn, v)
    mass = attn.reshape(G, h, P, N, P, N).sum(-1)
    out = out + torch.einsum("ghpns,pshc->ghpnc", mass, ve).reshape(G, h, T, hd)
    return _window_merge(out[None], (B, Hp, Wp, N), window).to(qkv.dtype)


def _window_bwd_finish(dqkv, qkv, table, dqr, dkr, dve, window, num_heads):
    """From the content gradients (f32 d(qkv) [B, Hp, Wp, N, 3C]), dqr and
    dkr ([G, h, T, P], the gradients of the pixel-granular positional
    logits) and d(ve) ([h, P, P, hd]): add the positional halves dqr.ke and
    dkr.qe to d(q) and d(k), form the q/k table gradients and scatter all
    three into the rows of the table (a gather and a sum in a fixed order,
    so two calls give the same bits).  Plain tensor products, the part the
    JAX package leaves to XLA.  Returns (d(qkv) in qkv's dtype, d(table)
    f32)."""
    B, Hp, Wp, N, C3 = qkv.shape
    C = C3 // 3
    h = num_heads
    hd = C // h
    P = window[0] * window[1]
    scale = hd ** -0.5
    q, k = _window_split(qkv[..., :2 * C], window, h, 2)
    G = q.shape[0]
    qe, ke, _ = _window_tables(table, window, h)
    dqr5 = dqr.reshape(G, h, P, N, P)
    dkr5 = dkr.reshape(G, h, P, N, P)
    q5 = q.reshape(G, h, P, N, hd)
    k5 = k.reshape(G, h, P, N, hd)
    dq_pos = torch.einsum("ghpns,pshc->ghpnc", dqr5, ke) * scale
    dk_pos = torch.einsum("ghsmp,pshc->ghsmc", dkr5, qe) * scale
    d_ke = torch.einsum("ghpns,ghpnc->pshc", dqr5, q5) * scale
    d_qe = torch.einsum("ghsmp,ghsmc->pshc", dkr5, k5) * scale
    pos = torch.stack([dq_pos, dk_pos]).reshape(2, G, h, P * N, hd)
    dqkv[..., :2 * C] += _window_merge(pos, (B, Hp, Wp, N), window)
    d_rpe = torch.stack([d_qe, d_ke, dve.permute(1, 2, 0, 3)], dim=3)
    d_rpe = torch.cat([d_rpe.reshape(P * P, C3), d_rpe.new_zeros(1, C3)])
    index = torch.as_tensor(_window_scatter_index(*window), device=table.device)
    return dqkv.to(qkv.dtype), d_rpe[index].sum(1)


def window_attention_bwd_plain(g, qkv, rel_table, shift, window, num_heads,
                               candidate_mask, row0=0, hp_total=None):
    """Plain PyTorch version of :func:`window_attention_bwd` (f32 math, the
    softmax backward written out as in ``_bwd_head_core``)."""
    B, Hp, Wp, N, C = _window_shapes(qkv, rel_table, window, num_heads, row0,
                                     hp_total)
    h = num_heads
    q, k, v = _window_split(qkv, window, h, 3)
    (gw,) = _window_split(g, window, h, 1)
    table = rel_table.detach().to(qkv.dtype).float()
    qe, ke, ve = _window_tables(table, window, h)
    attn = _window_probs(q, k, qe, ke, (B, Hp, Wp, N), window, shift,
                         candidate_mask, row0, hp_total)
    G, _, T, hd = q.shape
    P = T // N
    # dP = g.v^T + gve[i, pix(j)], gve[i, s] = g_i . ve[pix(i), s]
    gve = torch.einsum("ghpnc,pshc->ghpns", gw.reshape(G, h, P, N, hd), ve)
    dattn = gw @ v.transpose(-1, -2) \
        + gve.reshape(G, h, T, P).repeat_interleave(N, dim=-1)
    dS = attn * (dattn - (dattn * attn).sum(-1, keepdim=True))
    dq = dS @ k * hd ** -0.5
    dk = dS.transpose(-1, -2) @ q * hd ** -0.5
    dv = attn.transpose(-1, -2) @ gw
    dqr = dS.reshape(G, h, T, P, N).sum(-1)
    dkr = dS.transpose(-1, -2).reshape(G, h, T, P, N).sum(-1)
    mass = attn.reshape(G, h, P, N, P, N).sum(-1)
    dve = torch.einsum("ghpns,ghpnc->hpsc", mass, gw.reshape(G, h, P, N, hd))
    dqkv = _window_merge(torch.stack([dq, dk, dv]), (B, Hp, Wp, N), window)
    return _window_bwd_finish(dqkv, qkv, table, dqr, dkr, dve, window, h)


def window_attention_pos_bwd_plain(g, qkv, rel_table, shift, window,
                                   num_heads, candidate_mask, row0=0,
                                   hp_total=None):
    """Plain PyTorch version of :func:`window_attention_pos_bwd`.  B7
    computes K1b's function (``_wan_bwd_fused_pos_kernel`` is
    ``_wan_bwd_kernel_direct`` with the positional backward moved into the
    kernel), so this is :func:`window_attention_bwd_plain`: the softmax
    backward, then the positional products and the table scatter of
    :func:`_window_bwd_finish`."""
    return window_attention_bwd_plain(g, qkv, rel_table, shift, window,
                                      num_heads, candidate_mask, row0,
                                      hp_total)


def _window_kernel_checks(kernel, qkv, rel_table, shift, window, num_heads):
    if qkv.device.type != "cuda" or rel_table.device != qkv.device:
        raise ValueError(f"{kernel}: qkv and rel_table must both be on one "
                         f"CUDA device, got {qkv.device}, {rel_table.device}")
    if not qkv.is_contiguous():
        raise ValueError(f"{kernel}: qkv must be contiguous")
    wh, ww = window
    if not 0 <= int(shift) < min(wh, ww):
        raise ValueError(f"shift {shift} outside [0, {min(wh, ww)})")
    C = qkv.shape[-1] // 3
    if C // num_heads not in _KERNEL_HEAD_DIMS or wh * ww > 64:
        raise ValueError(f"{kernel} kernel takes head dims "
                         f"{_KERNEL_HEAD_DIMS} and windows of at most 64 "
                         f"pixels, got {C // num_heads} and {wh}x{ww}")


def _window_attention_launch(qkv, rel_table, shift, window, num_heads,
                             candidate_mask, row0, hp_total):
    B, Hp, Wp, N, C = qkv.shape[:4] + (qkv.shape[4] // 3,)
    wh, ww = window
    table = rel_table.detach().to(qkv.dtype).float().contiguous()
    out = torch.empty((B, Hp, Wp, N, C), dtype=qkv.dtype, device=qkv.device)
    _native.launch(
        "window_attention", qkv.data_ptr(), table.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[qkv.dtype], B, Hp, Wp, N, C, num_heads, wh, ww,
        int(shift), int(bool(candidate_mask)), int(row0),
        Hp if hp_total is None else int(hp_total), (C // num_heads) ** -0.5,
        variants=WINDOW_VARIANTS)
    return out


def _window_attention_fake(qkv, rel_table, shift, window, num_heads,
                           candidate_mask, row0, hp_total):
    return qkv.new_empty(tuple(qkv.shape[:4]) + (qkv.shape[4] // 3,))


# K1 as the registered operator nmrf::window_attention (``ops/library.py``)
window_attention_op = library.define(
    "window_attention(Tensor qkv, Tensor rel_table, int shift, int[2] window, "
    "int num_heads, bool candidate_mask, int row0, int? hp_total) -> Tensor",
    _window_attention_launch, _window_attention_fake)


class _WindowAttentionFn(torch.autograd.Function):
    """K1 forward, K1b backward; with ``fused_pos`` B7 backward.  On the
    CPU (``fused_pos`` only) the plain forward and B7's plain version."""

    @staticmethod
    def forward(ctx, qkv, rel_table, shift, window, num_heads, candidate_mask,
                row0, hp_total, fused_pos):
        ctx.save_for_backward(qkv, rel_table)
        ctx.args = (shift, window, num_heads, candidate_mask, row0, hp_total)
        ctx.fused_pos = fused_pos
        if qkv.device.type == "cpu":
            return window_attention_plain(qkv, rel_table, *ctx.args)
        return window_attention_op(qkv, rel_table, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        qkv, rel_table = ctx.saved_tensors
        bwd = window_attention_pos_bwd if ctx.fused_pos else window_attention_bwd
        dqkv, d_table = bwd(g, qkv, rel_table, *ctx.args)
        return (dqkv, d_table.to(rel_table.dtype)) + (None,) * 7


def window_attention(qkv, rel_table, shift, window, num_heads, candidate_mask,
                     row0=0, hp_total=None, fused_pos=False):
    """Windowed NMP attention of one (already rolled and padded) layer input.

    qkv: [B, Hp, Wp, N, 3C], channels in (component, head, hd) order.
    rel_table: [(2wh-1)(2ww-1), 3C] relative-position table, columns in
      (head, component, hd) order; rounded to qkv's dtype as the JAX
      package rounds it, then used in f32.
    shift: the layer's cyclic shift (0 or wh//2); > 0 adds the shifted-
      region mask.  candidate_mask: block other candidates of a pixel.
    row0, hp_total: under H-sharding qkv is one tile of the image; the
      shifted-region mask then takes the global row row0 + y of local row
      y against the global padded height hp_total (default: 0 and Hp).
    fused_pos: differentiate through :func:`window_attention_pos_bwd` (B7,
      the JAX package's ``NMRF_FUSED_POS=1`` backward) instead of K1b; on
      the CPU through B7's plain version.  The forward is the same.
    Returns [B, Hp, Wp, N, C] in qkv's dtype.  Differentiable in qkv and
    rel_table (on CUDA through :func:`window_attention_bwd`).  On CUDA
    tensors K1 runs as the operator ``nmrf::window_attention``, called
    directly where no gradient is recorded.
    """
    _window_shapes(qkv, rel_table, window, num_heads, row0, hp_total)
    if qkv.device.type == "cpu" and not fused_pos:
        return window_attention_plain(qkv, rel_table, shift, window,
                                      num_heads, candidate_mask, row0,
                                      hp_total)
    if qkv.device.type != "cpu":
        _window_kernel_checks("window_attention", qkv, rel_table, shift,
                              window, num_heads)
        if not library.needs_grad(qkv, rel_table):
            return window_attention_op(qkv, rel_table, shift, window,
                                       num_heads, candidate_mask, row0,
                                       hp_total)
    return _WindowAttentionFn.apply(qkv, rel_table, shift, window, num_heads,
                                    candidate_mask, row0, hp_total,
                                    bool(fused_pos))


def _window_bwd_kernel_inputs(kernel, g, qkv, rel_table, shift, window,
                              num_heads):
    """Checks of a window backward kernel's CUDA inputs; returns g in qkv's
    dtype and the table rounded to qkv's dtype in f32, both contiguous."""
    _window_kernel_checks(kernel, qkv, rel_table, shift, window, num_heads)
    if g.device != qkv.device:
        raise ValueError(f"{kernel}: g on {g.device}, qkv on {qkv.device}")
    return (g.to(qkv.dtype).contiguous(),
            rel_table.detach().to(qkv.dtype).float().contiguous())


def window_attention_bwd(g, qkv, rel_table, shift, window, num_heads,
                         candidate_mask, row0=0, hp_total=None):
    """Gradients of :func:`window_attention` given g = dL/dout
    [B, Hp, Wp, N, C]: (d(qkv) in qkv's dtype, d(rel_table) f32).

    On CUDA tensors one launch of K1b (the softmax backward, dqr/dkr and
    the d(ve) reduction over fixed-order partials,
    ``csrc/window_attention_bwd.cu``), then the positional products of
    :func:`_window_bwd_finish`."""
    B, Hp, Wp, N, C = _window_shapes(qkv, rel_table, window, num_heads, row0,
                                     hp_total)
    if tuple(g.shape) != (B, Hp, Wp, N, C):
        raise ValueError(f"g shape {tuple(g.shape)}, expected "
                         f"{(B, Hp, Wp, N, C)}")
    if qkv.device.type == "cpu":
        return window_attention_bwd_plain(g, qkv, rel_table, shift, window,
                                          num_heads, candidate_mask, row0,
                                          hp_total)
    g, table = _window_bwd_kernel_inputs("window_attention_bwd", g, qkv,
                                         rel_table, shift, window, num_heads)
    wh, ww = window
    h = num_heads
    P = wh * ww
    T = P * N
    G = B * (Hp // wh) * (Wp // ww)
    f32 = dict(dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty((B, Hp, Wp, N, 3 * C), **f32)
    dqr, dkr, mass = (torch.empty((G, h, T, P), **f32) for _ in range(3))
    dve = torch.empty((h, P, P, C // h), **f32)
    nsplit = _dve_splits(G * N, P, h)
    dve_partial = torch.empty((nsplit,) + tuple(dve.shape), **f32)
    _native.launch(
        "window_attention_bwd", qkv.data_ptr(), table.data_ptr(),
        g.data_ptr(), dqkv.data_ptr(), dqr.data_ptr(), dkr.data_ptr(),
        mass.data_ptr(), dve.data_ptr(), dve_partial.data_ptr(),
        _DTYPE_CODES[qkv.dtype], B, Hp, Wp, N, C, h, wh, ww, int(shift),
        int(bool(candidate_mask)), int(row0),
        Hp if hp_total is None else int(hp_total), nsplit, (C // h) ** -0.5)
    return _window_bwd_finish(dqkv, qkv, table, dqr, dkr, dve, window, h)


def window_attention_pos_bwd(g, qkv, rel_table, shift, window, num_heads,
                             candidate_mask, row0=0, hp_total=None):
    """Gradients of :func:`window_attention` given g = dL/dout
    [B, Hp, Wp, N, C], the function of :func:`window_attention_bwd`:
    (d(qkv) in qkv's dtype, d(rel_table) f32).

    On CUDA tensors one launch of B7 (``csrc/window_attention_pos_bwd.cu``:
    the softmax backward with the positional halves of d(q) and d(k) and
    the q, k and v table cotangents in the kernel, then the sum of its
    per-block table partials); no dqr, dkr or mass buffer."""
    B, Hp, Wp, N, C = _window_shapes(qkv, rel_table, window, num_heads, row0,
                                     hp_total)
    if tuple(g.shape) != (B, Hp, Wp, N, C):
        raise ValueError(f"g shape {tuple(g.shape)}, expected "
                         f"{(B, Hp, Wp, N, C)}")
    if qkv.device.type == "cpu":
        return window_attention_pos_bwd_plain(g, qkv, rel_table, shift,
                                              window, num_heads,
                                              candidate_mask, row0, hp_total)
    g, table = _window_bwd_kernel_inputs("window_attention_pos_bwd", g, qkv,
                                         rel_table, shift, window, num_heads)
    wh, ww = window
    nblk = max(1, min(B * (Hp // wh) * (Wp // ww),
                      _POS_BWD_BLOCKS // num_heads))
    f32 = dict(dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    partial = torch.empty((nblk,) + tuple(table.shape), **f32)
    d_table = torch.empty(table.shape, **f32)
    _native.launch(
        "window_attention_pos_bwd", qkv.data_ptr(), table.data_ptr(),
        g.data_ptr(), dqkv.data_ptr(), partial.data_ptr(), d_table.data_ptr(),
        _DTYPE_CODES[qkv.dtype], B, Hp, Wp, N, C, num_heads, wh, ww,
        int(shift), int(bool(candidate_mask)), int(row0),
        Hp if hp_total is None else int(hp_total), nblk,
        (C // num_heads) ** -0.5)
    return dqkv, d_table


# --------------------------------------------------------------------------- #
# K2 / K2b: CSWin stripe attention
# --------------------------------------------------------------------------- #

@lru_cache(maxsize=16)
def stripe_mask(T: int, N: int) -> np.ndarray:
    """[T, T] anti-same-pixel mask of a stripe, tokens in (hs, ws, n) order:
    different candidates of one pixel never see each other
    (reference ``gen_window_attn_mask``, ``nmp.py:35``)."""
    pix = np.arange(T) // N
    same = (pix[:, None] == pix[None, :]) & ~np.eye(T, dtype=bool)
    return np.where(same, NEG_INF, 0.0).astype(np.float32)


def _stripe_shapes(q, k, v, H_sp, W_sp, num_heads):
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, t, 5)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have one shape")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must have one dtype")
    B, Hp, Wp, N, C = q.shape
    if Hp % H_sp or Wp % W_sp:
        raise ValueError(f"padded size {Hp}x{Wp} not a multiple of stripe "
                         f"{H_sp}x{W_sp}")
    if C % num_heads:
        raise ValueError(f"channels {C} not divisible by {num_heads} heads")
    return B, Hp, Wp, N, C


def _stripe_split(t, H_sp, W_sp, num_heads):
    """[B, Hp, Wp, N, C] -> [stripes, h, T, hd] f32."""
    B, Hp, Wp, N, C = t.shape
    hd = C // num_heads
    t = t.float().reshape(B, Hp // H_sp, H_sp, Wp // W_sp, W_sp, N,
                          num_heads, hd)
    return t.permute(0, 1, 3, 6, 2, 4, 5, 7).reshape(-1, num_heads,
                                                     H_sp * W_sp * N, hd)


def _stripe_merge(t, shape, H_sp, W_sp):
    B, Hp, Wp, N = shape
    _, h, _, hd = t.shape
    t = t.reshape(B, Hp // H_sp, Wp // W_sp, h, H_sp, W_sp, N, hd)
    return t.permute(0, 1, 4, 2, 5, 6, 3, 7).reshape(B, Hp, Wp, N, h * hd)


def _stripe_probs(qs, ks, N):
    """Softmax of scale q.k + the anti-same-pixel mask, q pre-scaled."""
    T = qs.shape[2]
    mask = device_constant(stripe_mask, (T, N), qs.device)
    return torch.softmax(qs @ ks.transpose(-1, -2) + mask, dim=-1)


def stripe_attention_plain(q, k, v, H_sp, W_sp, num_heads):
    """Plain PyTorch version of :func:`stripe_attention` (f32 math)."""
    B, Hp, Wp, N, C = _stripe_shapes(q, k, v, H_sp, W_sp, num_heads)
    scale = (C // num_heads) ** -0.5
    qs, ks, vs = (_stripe_split(t, H_sp, W_sp, num_heads) for t in (q, k, v))
    out = _stripe_probs(qs * scale, ks, N) @ vs
    return _stripe_merge(out, (B, Hp, Wp, N), H_sp, W_sp).to(q.dtype)


def stripe_attention_bwd_plain(g, q, k, v, H_sp, W_sp, num_heads):
    """Plain PyTorch version of :func:`stripe_attention_bwd` (f32 math, the
    softmax backward written out as in ``_stripe_bwd_kernel``)."""
    B, Hp, Wp, N, C = _stripe_shapes(q, k, v, H_sp, W_sp, num_heads)
    scale = (C // num_heads) ** -0.5
    qs, ks, vs, gs = (_stripe_split(t, H_sp, W_sp, num_heads)
                      for t in (q, k, v, g))
    qs = qs * scale
    attn = _stripe_probs(qs, ks, N)
    dattn = gs @ vs.transpose(-1, -2)
    dS = attn * (dattn - (dattn * attn).sum(-1, keepdim=True))
    grads = (dS @ ks * scale, dS.transpose(-1, -2) @ qs,
             attn.transpose(-1, -2) @ gs)
    return tuple(_stripe_merge(t, (B, Hp, Wp, N), H_sp, W_sp).to(q.dtype)
                 for t in grads)


def _stripe_kernel_checks(kernel, tensors, num_heads):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{kernel}: inputs must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel}: inputs must be contiguous")
    hd = tensors[0].shape[-1] // num_heads
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} kernel takes head dims "
                         f"{_KERNEL_HEAD_DIMS}, got {hd}")


def _stripe_attention_launch(q, k, v, H_sp, W_sp, num_heads):
    B, Hp, Wp, N, C = q.shape
    out = torch.empty_like(q)
    _native.launch(
        "stripe_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), _DTYPE_CODES[q.dtype], B, Hp, Wp, N, C, num_heads,
        H_sp, W_sp, (C // num_heads) ** -0.5)
    return out


def _stripe_attention_fake(q, k, v, H_sp, W_sp, num_heads):
    return torch.empty_like(q)


# K2 as the registered operator nmrf::stripe_attention (``ops/library.py``)
stripe_attention_op = library.define(
    "stripe_attention(Tensor q, Tensor k, Tensor v, int H_sp, int W_sp, "
    "int num_heads) -> Tensor",
    _stripe_attention_launch, _stripe_attention_fake)


class _StripeAttentionFn(torch.autograd.Function):
    """K2 forward, K2b backward."""

    @staticmethod
    def forward(ctx, q, k, v, H_sp, W_sp, num_heads):
        ctx.save_for_backward(q, k, v)
        ctx.args = (H_sp, W_sp, num_heads)
        return stripe_attention_op(q, k, v, H_sp, W_sp, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return stripe_attention_bwd(g, q, k, v, *ctx.args) + (None,) * 3


def stripe_attention(q, k, v, H_sp, W_sp, num_heads):
    """CSWin stripe attention on padded image-layout tensors.

    q/k/v: [B, Hp, Wp, N, C] (already padded to stripe multiples), channels
    in (head, hd) order.  Each H_sp x W_sp stripe of tokens attends within
    itself under the anti-same-pixel mask.  Returns [B, Hp, Wp, N, C].
    Differentiable (on CUDA through :func:`stripe_attention_bwd`).  On CUDA
    tensors K2 runs as the operator ``nmrf::stripe_attention``, called
    directly where no gradient is recorded.
    """
    _stripe_shapes(q, k, v, H_sp, W_sp, num_heads)
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return stripe_attention_plain(q, k, v, H_sp, W_sp, num_heads)
    _stripe_kernel_checks("stripe_attention", (q, k, v), num_heads)
    if not library.needs_grad(q, k, v):
        return stripe_attention_op(q, k, v, H_sp, W_sp, num_heads)
    return _StripeAttentionFn.apply(q, k, v, H_sp, W_sp, num_heads)


def stripe_attention_bwd(g, q, k, v, H_sp, W_sp, num_heads):
    """Gradients (dq, dk, dv) of :func:`stripe_attention` given g = dL/dout,
    in q's dtype.  On CUDA tensors one launch of K2b
    (``csrc/stripe_attention_bwd.cu``)."""
    B, Hp, Wp, N, C = _stripe_shapes(q, k, v, H_sp, W_sp, num_heads)
    if g.shape != q.shape:
        raise ValueError(f"g shape {tuple(g.shape)}, expected {tuple(q.shape)}")
    if all(t.device.type == "cpu" for t in (g, q, k, v)):
        return stripe_attention_bwd_plain(g, q, k, v, H_sp, W_sp, num_heads)
    g = g.to(q.dtype).contiguous()
    _stripe_kernel_checks("stripe_attention_bwd", (q, k, v, g), num_heads)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    rows = (B * (Hp // H_sp) * (Wp // W_sp), num_heads, H_sp * W_sp * N)
    lse, dsum = (torch.empty(rows, dtype=torch.float32, device=q.device)
                 for _ in range(2))
    _native.launch(
        "stripe_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), _DTYPE_CODES[q.dtype], B, Hp, Wp, N,
        C, num_heads, H_sp, W_sp, (C // num_heads) ** -0.5)
    return dq, dk, dv


# --------------------------------------------------------------------------- #
# B6 / B6b: rectangular masked attention (H-sharded CSWin vertical stripe)
# --------------------------------------------------------------------------- #

def _masked_shapes(q, k, v, mask):
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, t, 4)
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}, "
                         f"{tuple(v.shape)}: expected [h, G, Rq, hd] and "
                         "[h, G, Rk, hd]")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must have one dtype")
    h, G, Rq, hd = q.shape
    Rk = k.shape[2]
    if mask.dim() != 3 or mask.shape[1:] != (Rq, Rk) \
            or mask.shape[0] not in (1, G):
        raise ValueError(f"mask {tuple(mask.shape)}: expected [Gm, {Rq}, "
                         f"{Rk}] with Gm in (1, {G})")
    return h, G, Rq, Rk, hd


def _masked_probs(qs, k, mask):
    """Softmax of q.k + mask over the keys, q pre-scaled: [h, G, Rq, Rk]."""
    return torch.softmax(qs @ k.transpose(-1, -2) + mask.float()[None], dim=-1)


def masked_attention_plain(q, k, v, mask, scale):
    """Plain PyTorch version of :func:`masked_attention` (f32 math), from
    ``masked_attention_reference`` (``attention.py:111-122``)."""
    _masked_shapes(q, k, v, mask)
    attn = _masked_probs(q.float() * scale, k.float(), mask)
    return (attn @ v.float()).to(q.dtype)


def masked_attention_bwd_plain(g, q, k, v, mask, scale):
    """Plain PyTorch version of :func:`masked_attention_bwd` (f32 math, the
    softmax backward written out as in ``_masked_attention_bwd_kernel``,
    ``attention.py:135-157``: the scale enters dq, and dk through the
    pre-scaled q)."""
    _masked_shapes(q, k, v, mask)
    qs, kf, vf, gf = q.float() * scale, k.float(), v.float(), g.float()
    attn = _masked_probs(qs, kf, mask)
    dattn = gf @ vf.transpose(-1, -2)
    dS = attn * (dattn - (dattn * attn).sum(-1, keepdim=True))
    return ((dS @ kf * scale).to(q.dtype),
            (dS.transpose(-1, -2) @ qs).to(k.dtype),
            (attn.transpose(-1, -2) @ gf).to(v.dtype))


def _masked_kernel_checks(kernel, tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{kernel}: inputs must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel}: inputs must be contiguous")
    hd = tensors[0].shape[-1]
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} kernel takes head dims "
                         f"{_KERNEL_HEAD_DIMS}, got {hd}")


def _masked_attention_launch(q, k, v, mask, scale):
    """One B6 launch on inputs that :func:`_masked_shapes` has passed."""
    h, G, Rq, hd = q.shape
    Rk = k.shape[2]
    mask = mask.float().contiguous()
    _masked_kernel_checks("masked_attention", (q, k, v, mask))
    out = torch.empty_like(q)
    _native.launch(
        "masked_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype], G,
        mask.shape[0], h, Rq, Rk, hd, float(scale))
    return out


class _MaskedAttentionFn(torch.autograd.Function):
    """B6 forward, B6b backward (the mask takes no gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        ctx.save_for_backward(q, k, v, mask)
        ctx.scale = scale
        return _masked_attention_launch(q, k, v, mask, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        return masked_attention_bwd(g, q, k, v, mask, ctx.scale) + (None, None)


def masked_attention(q, k, v, mask, scale):
    """``softmax(q k^T * scale + mask) v`` with Rq query and Rk key rows.

    q: [h, G, Rq, hd]; k, v: [h, G, Rk, hd]; mask: [Gm, Rq, Rk] additive
    f32 with Gm in {1, G} (Gm = 1 broadcasts).  Returns [h, G, Rq, hd] in
    q's dtype.  Differentiable in q, k and v (on CUDA through
    :func:`masked_attention_bwd`).
    """
    _masked_shapes(q, k, v, mask)
    if all(t.device.type == "cpu" for t in (q, k, v, mask)):
        return masked_attention_plain(q, k, v, mask, scale)
    return _MaskedAttentionFn.apply(q, k, v, mask, scale)


def masked_attention_bwd(g, q, k, v, mask, scale):
    """Gradients (dq, dk, dv) of :func:`masked_attention` given
    g = dL/dout, in the inputs' dtype.  On CUDA tensors one launch of B6b
    (``csrc/masked_attention_bwd.cu``: a query-side and a key-side
    kernel)."""
    h, G, Rq, Rk, hd = _masked_shapes(q, k, v, mask)
    if g.shape != q.shape:
        raise ValueError(f"g shape {tuple(g.shape)}, expected {tuple(q.shape)}")
    if all(t.device.type == "cpu" for t in (g, q, k, v, mask)):
        return masked_attention_bwd_plain(g, q, k, v, mask, scale)
    g = g.to(q.dtype).contiguous()
    mask = mask.float().contiguous()
    _masked_kernel_checks("masked_attention_bwd", (q, k, v, g, mask))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the query side's softmax statistics: row max and log-sum ([2, h, G,
    # Rq]) and D_i ([h, G, Rq])
    f32 = dict(dtype=torch.float32, device=q.device)
    stats, dsum = torch.empty((2, h, G, Rq), **f32), torch.empty((h, G, Rq), **f32)
    _native.launch(
        "masked_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), stats.data_ptr(), dsum.data_ptr(),
        _DTYPE_CODES[q.dtype], G, mask.shape[0], h, Rq, Rk, hd, float(scale))
    return dq, dk, dv
