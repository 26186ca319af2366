"""NMP attention kernels: window attention (K1) and stripe attention (K2).

Each function here has three parts:

* the wrapper (``window_attention``, ``stripe_attention``), which checks its
  inputs and, for CUDA tensors, launches the hand-written kernel from
  ``nmrf_tpu_torch/csrc`` on the current stream, raising if the launch
  fails.  It counts its launches in ``<wrapper>.launches``;
* the plain PyTorch version (``*_plain``) of the same function.  The wrapper
  takes it only for tensors on the CPU; the tests and ``chip_smoke.py``
  hold the kernel against it;
* the source note in the ``.cu`` file: which TPU kernel it replaces, what
  bounds it on the H100 and what its design does about that.

K1 replaces ``nmrf_tpu/ops/pallas/attention.py:_window_native_kernel_direct``
(and the transposed ``_window_native_kernel``, the same function); K2
replaces ``_stripe_attention_kernel``.  Both are inference-only in this
package: a CUDA input that requires grad raises NotImplementedError.
"""

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import _native

NEG_INF = -1e9  # finite -inf stand-in, softmax-safe
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (16, 32, 64)


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


def reset_launch_counts():
    window_attention.launches = 0
    stripe_attention.launches = 0


def launch_counts():
    return {"window_attention": window_attention.launches,
            "stripe_attention": stripe_attention.launches}


def _check_tensor(name, t, ndim):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")


def _check_inference_only(kernel, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: the CUDA kernel has no backward yet (the training "
            "slice of the port adds it); call under torch.inference_mode()")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# --------------------------------------------------------------------------- #
# K1: shifted-window attention with relative-position terms
# --------------------------------------------------------------------------- #

@lru_cache(maxsize=32)
def _window_mask(Hp, Wp, wh, ww, N, shift, candidate_mask):
    """[nwh*nww, T, T] additive mask of every window, from token coordinates
    (candidate mask and shifted-region mask, as the kernel builds them)."""
    P = wh * ww
    t = np.arange(P * N)
    pix = t // N
    mask = np.zeros((Hp // wh, Wp // ww, P * N, P * N), np.float32)
    if candidate_mask:
        same = (pix[:, None] == pix[None, :]) & (t[:, None] != t[None, :])
        mask += np.where(same, NEG_INF, 0.0).astype(np.float32)
    if shift > 0:
        y = np.arange(Hp // wh)[:, None] * wh + (pix // ww)[None, :]
        x = np.arange(Wp // ww)[:, None] * ww + (pix % ww)[None, :]
        ry = (y >= Hp - wh).astype(int) + (y >= Hp - shift)
        rx = (x >= Wp - ww).astype(int) + (x >= Wp - shift)
        reg = 3 * ry[:, None, :] + rx[None, :, :]          # [nwh, nww, T]
        diff = reg[..., :, None] != reg[..., None, :]
        mask += np.where(diff, NEG_INF, 0.0).astype(np.float32)
    return mask.reshape(-1, P * N, P * N)


def _window_shapes(qkv, rel_table, window, num_heads):
    _check_tensor("qkv", qkv, 5)
    B, Hp, Wp, N, C3 = qkv.shape
    wh, ww = window
    if C3 % (3 * num_heads):
        raise ValueError(f"qkv channels {C3} not divisible by 3*{num_heads}")
    if Hp % wh or Wp % ww:
        raise ValueError(f"padded size {Hp}x{Wp} not a multiple of {wh}x{ww}")
    C = C3 // 3
    if tuple(rel_table.shape) != ((2 * wh - 1) * (2 * ww - 1), C3):
        raise ValueError(f"rel_table shape {tuple(rel_table.shape)} does not "
                         f"match window {window} and 3C = {C3}")
    return B, Hp, Wp, N, C


def window_attention_plain(qkv, rel_table, shift, window, num_heads,
                           candidate_mask):
    """Plain PyTorch version of :func:`window_attention` (f32 math)."""
    B, Hp, Wp, N, C = _window_shapes(qkv, rel_table, window, num_heads)
    wh, ww = window
    h = num_heads
    hd = C // h
    P, T = wh * ww, wh * ww * N
    nwh, nww = Hp // wh, Wp // ww
    G = B * nwh * nww
    scale = hd ** -0.5
    x = qkv.float().reshape(B, nwh, wh, nww, ww, N, 3, h, hd)
    x = x.permute(6, 0, 1, 3, 7, 2, 4, 5, 8).reshape(3, G, h, T, hd)
    q, k, v = x[0], x[1], x[2]
    idx = torch.as_tensor(relative_position_index(wh, ww).reshape(-1),
                          device=qkv.device)
    rpe = rel_table.to(qkv.dtype).float()[idx].reshape(P, P, h, 3, hd)
    qe, ke, ve = rpe[..., 0, :], rpe[..., 1, :], rpe[..., 2, :]

    logits = torch.einsum("ghic,ghjc->ghij", q, k) * scale
    q5 = q.reshape(G, h, P, N, hd)
    k5 = k.reshape(G, h, P, N, hd)
    qr = torch.einsum("ghpnc,pshc->ghpns", q5, ke) * scale
    kr = torch.einsum("ghsmc,pshc->ghpsm", k5, qe) * scale
    logits = logits.reshape(G, h, P, N, P, N) + qr[..., None] + kr[:, :, :, None]
    mask = torch.as_tensor(
        _window_mask(Hp, Wp, wh, ww, N, int(shift), bool(candidate_mask)),
        device=qkv.device)
    logits = logits.reshape(B, nwh * nww, h, T, T) + mask[None, :, None]
    attn = torch.softmax(logits.reshape(G, h, T, T), dim=-1)
    out = torch.einsum("ghij,ghjc->ghic", attn, v)
    mass = attn.reshape(G, h, P, N, P, N).sum(-1)
    out = out + torch.einsum("ghpns,pshc->ghpnc", mass, ve).reshape(G, h, T, hd)
    out = out.reshape(B, nwh, nww, h, wh, ww, N, hd)
    out = out.permute(0, 1, 4, 2, 5, 6, 3, 7).reshape(B, Hp, Wp, N, C)
    return out.to(qkv.dtype)


def window_attention(qkv, rel_table, shift, window, num_heads, candidate_mask):
    """Windowed NMP attention of one (already rolled and padded) layer input.

    qkv: [B, Hp, Wp, N, 3C], channels in (component, head, hd) order.
    rel_table: [(2wh-1)(2ww-1), 3C] relative-position table, columns in
      (head, component, hd) order; rounded to qkv's dtype as the JAX
      package rounds it, then used in f32.
    shift: the layer's cyclic shift (0 or wh//2); > 0 adds the shifted-
      region mask.  candidate_mask: block other candidates of a pixel.
    Returns [B, Hp, Wp, N, C] in qkv's dtype.
    """
    B, Hp, Wp, N, C = _window_shapes(qkv, rel_table, window, num_heads)
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, rel_table, shift, window,
                                      num_heads, candidate_mask)
    if qkv.device.type != "cuda" or rel_table.device != qkv.device:
        raise ValueError("window_attention: qkv and rel_table must both be "
                         f"on one CUDA device, got {qkv.device}, "
                         f"{rel_table.device}")
    if not qkv.is_contiguous():
        raise ValueError("window_attention: qkv must be contiguous")
    _check_inference_only("window_attention", qkv, rel_table)
    wh, ww = window
    if not 0 <= int(shift) < min(wh, ww):
        raise ValueError(f"shift {shift} outside [0, {min(wh, ww)})")
    if C // num_heads not in _KERNEL_HEAD_DIMS or wh * ww > 64:
        raise ValueError(f"window_attention kernel takes head dims "
                         f"{_KERNEL_HEAD_DIMS} and windows of at most 64 "
                         f"pixels, got {C // num_heads} and {wh}x{ww}")
    table = rel_table.detach().to(qkv.dtype).float().contiguous()
    out = torch.empty((B, Hp, Wp, N, C), dtype=qkv.dtype, device=qkv.device)
    err = _native.library("window_attention")(
        qkv.data_ptr(), table.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[qkv.dtype], B, Hp, Wp, N, C, num_heads, wh, ww,
        int(shift), int(bool(candidate_mask)), (C // num_heads) ** -0.5,
        _stream())
    if err != 0:
        raise RuntimeError(f"window_attention kernel launch failed: CUDA "
                           f"error {err}")
    window_attention.launches += 1
    return out


window_attention.launches = 0


# --------------------------------------------------------------------------- #
# K2: CSWin stripe attention
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


def stripe_attention_plain(q, k, v, H_sp, W_sp, num_heads):
    """Plain PyTorch version of :func:`stripe_attention` (f32 math)."""
    B, Hp, Wp, N, C = _stripe_shapes(q, k, v, H_sp, W_sp, num_heads)
    h = num_heads
    hd = C // h
    ni, nj = Hp // H_sp, Wp // W_sp
    T = H_sp * W_sp * N

    def st(t):  # [B, Hp, Wp, N, C] -> [B*ni*nj, h, T, hd]
        t = t.float().reshape(B, ni, H_sp, nj, W_sp, N, h, hd)
        return t.permute(0, 1, 3, 6, 2, 4, 5, 7).reshape(B * ni * nj, h, T, hd)

    mask = torch.as_tensor(stripe_mask(T, N), device=q.device)
    logits = torch.einsum("ghic,ghjc->ghij", st(q) * hd ** -0.5, st(k))
    attn = torch.softmax(logits + mask, dim=-1)
    out = torch.einsum("ghij,ghjc->ghic", attn, st(v))
    out = out.reshape(B, ni, nj, h, H_sp, W_sp, N, hd)
    out = out.permute(0, 1, 4, 2, 5, 6, 3, 7).reshape(B, Hp, Wp, N, C)
    return out.to(q.dtype)


def stripe_attention(q, k, v, H_sp, W_sp, num_heads):
    """CSWin stripe attention on padded image-layout tensors.

    q/k/v: [B, Hp, Wp, N, C] (already padded to stripe multiples), channels
    in (head, hd) order.  Each H_sp x W_sp stripe of tokens attends within
    itself under the anti-same-pixel mask.  Returns [B, Hp, Wp, N, C].
    """
    B, Hp, Wp, N, C = _stripe_shapes(q, k, v, H_sp, W_sp, num_heads)
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return stripe_attention_plain(q, k, v, H_sp, W_sp, num_heads)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("stripe_attention: q, k and v must be on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("stripe_attention: q, k and v must be contiguous")
    _check_inference_only("stripe_attention", q, k, v)
    hd = C // num_heads
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"stripe_attention kernel takes head dims "
                         f"{_KERNEL_HEAD_DIMS}, got {hd}")
    out = torch.empty_like(q)
    err = _native.library("stripe_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], B, Hp, Wp, N, C, num_heads, H_sp, W_sp,
        hd ** -0.5, _stream())
    if err != 0:
        raise RuntimeError(f"stripe_attention kernel launch failed: CUDA "
                           f"error {err}")
    stripe_attention.launches += 1
    return out


stripe_attention.launches = 0
