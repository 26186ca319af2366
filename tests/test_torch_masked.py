"""The kernels' plain versions on the H-sharded path against the JAX package
(CPU, float32; atol = rtol = 1e-5: the same math, another summation order).

* B6 (``masked_attention_plain``) against ``masked_attention_reference``
  and the Pallas ``masked_attention`` in interpret mode, Rq != Rk, with one
  mask for every group (Gm = 1) and a mask per group (Gm = G); B6b
  (``masked_attention_bwd_plain``) against ``jax.vjp`` of the reference and
  of ``masked_attention_op`` (its Pallas backward in interpret mode);
* K1/K1b's plain versions at a tile of a taller image (row0 0 and 8,
  hp_total 16) against ``window_attention_native_reference(..., row0,
  hp_total)`` and its ``jax.vjp``;
* the masks the kernels build from row0/hp_total equal the JAX stages'
  per-tile shifted-window masks (``stages.py:357-371``), and the vertical
  stripe's tile mask equals the rows of the JAX global stripe mask
  (``nmp.py:652-656``);
* a model of the tensor-core B6 and B6b (``csrc/masked_attention.cu``,
  ``csrc/masked_attention_bwd.cu``) in torch f32: their row tiles, 64-row
  streamed tiles, 16-row chunks, online softmax and the key side's
  transposed mask reads, on ragged shapes (Rq 40, Rk 72) with a row masked
  everywhere, against the plain versions and the JAX Pallas kernels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nmrf_tpu.models.nmp import (_relative_position_index,
                                 shift_window_attn_mask, window_attn_mask)
from nmrf_tpu.ops.pallas import attention as fa
from nmrf_tpu.parallel.spatial import \
    split_shift_mask_per_tile as split_shift_mask_per_tile_jax
from nmrf_tpu_torch.models.nmp import tile_stripe_mask
from nmrf_tpu_torch.ops import attention as A
from nmrf_tpu_torch.parallel.spatial import split_shift_mask_per_tile

TOL = dict(atol=1e-5, rtol=1e-5)


def _masked_inputs(Gm, seed=0):
    h, G, Rq, Rk, hd = 2, 6, 5, 10, 8
    rng = np.random.RandomState(seed)
    q = rng.randn(h, G, Rq, hd).astype(np.float32)
    k, v = (rng.randn(h, G, Rk, hd).astype(np.float32) for _ in range(2))
    mask = np.where(rng.rand(Gm, Rq, Rk) < 0.3, -1e9, 0.0).astype(np.float32)
    mask[:, :, 0] = 0.0  # every row keeps a key
    mask += (0.5 * rng.randn(Gm, Rq, Rk)).astype(np.float32)
    g = rng.randn(h, G, Rq, hd).astype(np.float32)
    return q, k, v, mask, g, hd ** -0.5


@pytest.mark.parametrize("Gm", [1, 6])
def test_masked_plain_matches_jax(Gm):
    q, k, v, mask, _, scale = _masked_inputs(Gm)
    jq, jk, jv, jm = (jnp.asarray(x) for x in (q, k, v, mask))
    got = A.masked_attention_plain(*(torch.from_numpy(x) for x in (q, k, v, mask)),
                                   scale).numpy()
    np.testing.assert_allclose(
        got, np.asarray(fa.masked_attention_reference(jq, jk, jv, jm, scale)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(fa.masked_attention(jq, jk, jv, jm, scale,
                                            interpret=True)), **TOL)
    # the wrapper takes the plain version for CPU tensors
    wrapped = A.masked_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)),
                                 scale)
    np.testing.assert_array_equal(wrapped.numpy(), got)


@pytest.mark.parametrize("Gm", [1, 6])
def test_masked_bwd_plain_matches_jax_vjp(Gm):
    q, k, v, mask, g, scale = _masked_inputs(Gm, seed=1)
    jm = jnp.asarray(mask)
    got = A.masked_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (g, q, k, v, mask)), scale)
    for fn in (lambda q, k, v: fa.masked_attention_reference(q, k, v, jm, scale),
               lambda q, k, v: fa.masked_attention_op(q, k, v, jm, scale)):
        _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
        for name, a, b in zip("qkv", got, vjp(jnp.asarray(g))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                       **TOL)
    # autograd through the CPU wrapper gives the same gradients
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    A.masked_attention(*qkv, torch.from_numpy(mask), scale).backward(
        torch.from_numpy(g))
    for a, b in zip(got, qkv):
        torch.testing.assert_close(b.grad, a, **TOL)


def _window_reference(qkv, table, shift, ws, heads, cand, row0, hp_total):
    """The JAX window attention of a tile: the module's positional inputs
    and ``window_attention_native_reference`` (as ``tests/test_pallas.py``
    builds them)."""
    WB = 1
    hd = qkv.shape[-1] // (3 * heads)
    P = ws * ws
    rel = _relative_position_index(ws, ws)
    rpe = table[rel.reshape(-1)].reshape(P, P, heads, 3 * hd)
    q_e, k_e, v_e = jnp.split(rpe, 3, axis=-1)
    meta, _ = fa.window_meta(ws, ws, WB, qkv.shape[3])
    pixs = meta[:, 0]
    qr, kr = fa.window_positional_terms(qkv, k_e, q_e, hd ** -0.5, ws, ws, WB,
                                        heads)
    ve = v_e.transpose(2, 0, 3, 1)[:, pixs].reshape(heads, len(pixs), -1)
    return fa.window_attention_native_reference(
        qkv, qr, kr, ve, shift, hd ** -0.5, ws, ws, WB, heads, cand,
        row0=row0, hp_total=hp_total)


@pytest.mark.parametrize("row0", [0, 8])
@pytest.mark.parametrize("N,ws,shift,cand", [(2, 4, 2, True), (1, 4, 2, False)])
def test_window_row0_plain_matches_jax(N, ws, shift, cand, row0):
    """An 8-row tile at row0 of a 16-row image: forward and both gradients."""
    Ht, Wd, heads, dim = 8, 12, 2, 16
    rng = np.random.RandomState(2)
    qkv = rng.randn(1, Ht, Wd, N, 3 * dim).astype(np.float32)
    table = (0.3 * rng.randn((2 * ws - 1) ** 2, 3 * dim)).astype(np.float32)
    g = rng.randn(1, Ht, Wd, N, dim).astype(np.float32)
    args = (shift, ws, heads, cand, row0, 16)
    want, vjp = jax.vjp(lambda a, b: _window_reference(a, b, *args),
                        jnp.asarray(qkv), jnp.asarray(table))
    tq, tt, tg = (torch.from_numpy(x) for x in (qkv, table, g))
    got = A.window_attention_plain(tq, tt, shift, (ws, ws), heads, cand,
                                   row0=row0, hp_total=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dqkv, dtable = A.window_attention_bwd_plain(tg, tq, tt, shift, (ws, ws),
                                                heads, cand, row0=row0,
                                                hp_total=16)
    want_dqkv, want_dtable = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(want_dqkv), **TOL)
    np.testing.assert_allclose(dtable.numpy(), np.asarray(want_dtable), **TOL)
    # the last tile's regions are those of an 8-row image; the first tile
    # holds no region boundary, so there the global rows change the result
    plain = A.window_attention_plain(tq, tt, shift, (ws, ws), heads, cand)
    assert torch.allclose(plain, got, atol=1e-6) == (row0 == 8)


@pytest.mark.parametrize("N,ws,cand", [(4, 6, True), (1, 4, False)])
def test_row0_masks_equal_jax_tile_masks(N, ws, cand):
    """The plain path's per-tile shifted mask (built from row0/hp_total, as
    the kernels build it) is the JAX stages' tile of the global mask."""
    n, Ht, Wp = 2, 2 * ws, 3 * ws
    jax_tiles = split_shift_mask_per_tile_jax(shift_window_attn_mask(
        (n * Ht, Wp), (ws, ws, N), ws // 2, with_candidate_mask=cand), n)
    port_tiles = split_shift_mask_per_tile(
        A._window_mask(n * Ht, Wp, ws, ws, N, ws // 2, cand), n)
    for t in range(n):
        got = A._window_mask(Ht, Wp, ws, ws, N, ws // 2, cand, t * Ht, n * Ht)
        np.testing.assert_array_equal(got < -1e8, np.asarray(jax_tiles[t]) < -1e8)
        np.testing.assert_array_equal(got, port_tiles[t])


def test_vertical_stripe_tile_mask_equals_jax():
    n, Ht, W_sp, N = 2, 6, 1, 4
    Rq = Ht * W_sp * N
    full = window_attn_mask((n * Ht, W_sp, N)).reshape(n, Rq, n * Rq)
    mask = A.stripe_mask(n * Rq, N)
    for t in range(n):
        np.testing.assert_array_equal(mask[t * Rq:(t + 1) * Rq] < -1e8,
                                      full[t] < -1e8)


def test_vertical_stripe_tile_mask_is_cached():
    """The sharded CSWin layer's device mask: the tile's rows of the global
    stripe mask, built once per shape and reused by every layer call; a
    request (inference mode) that builds it first leaves a tensor that a
    training step can save for backward."""
    n, Ht, W_sp, N = 2, 6, 1, 4
    Rq = Ht * W_sp * N
    for t in range(n):
        with torch.inference_mode():
            got = tile_stripe_mask(n * Rq, N, t, Rq, torch.device("cpu"))
        assert not got.is_inference()
        assert got.shape == (1, Rq, n * Rq)
        np.testing.assert_array_equal(got[0].numpy(),
                                      A.stripe_mask(n * Rq, N)[t * Rq:(t + 1) * Rq])
        assert tile_stripe_mask(n * Rq, N, t, Rq, torch.device("cpu")) is got


# ---- a model of the tensor-core B6 / B6b tiling (f32) ---- #

_TILE, _CHUNK = 64, 16  # streamed tile rows, rows of an mma chunk
_LOG2E = 1.4426950408889634


def _rows(x, r0, n):
    """Rows r0..r0+n-1 of x [..., R, c], zero past R (the loaders'
    zero fill)."""
    out = x.new_zeros(x.shape[:-2] + (n, x.shape[-1]))
    part = x[..., r0:r0 + n, :]
    out[..., :part.shape[-2], :] = part
    return out


def _mask_block(mask, G, i0, ni, j0, nj):
    """[G, ni, nj] block of the [Gm, Rq, Rk] mask (g % Gm), zero past the
    edges, as the kernels stage it."""
    Gm, Rq, Rk = mask.shape
    out = mask.new_zeros(Gm, ni, nj)
    part = mask[:, i0:i0 + ni, j0:j0 + nj]
    out[:, :part.shape[1], :part.shape[2]] = part
    return out[torch.arange(G) % Gm]


def _q_rows(Rq):
    """Query rows a query-side block owns (``masked_q_rows``)."""
    return 128 if Rq >= 128 else -(-Rq // 16) * 16


def _chunks(R):
    """(tile start, chunk start) of the streamed tiles' 16-row chunks that
    start before R."""
    return [(t0, t0 + c) for t0 in range(0, R, _TILE)
            for c in range(0, _TILE, _CHUNK) if t0 + c < R]


def _b6_model(q, k, v, mask, scale):
    """B6's tensor-core forward: per row tile, 16-key chunks of the 64-key
    tiles, logits + mask in log2 units (-inf past Rk), online max and sum,
    one normalisation."""
    h, G, Rq, hd = q.shape
    Rk = k.shape[2]
    QT = _q_rows(Rq)
    out = torch.empty_like(q)
    for q0 in range(0, Rq, QT):
        qs = _rows(q, q0, QT)
        m = torch.full((h, G, QT), -torch.inf)
        l, o = torch.zeros(h, G, QT), torch.zeros(h, G, QT, hd)
        for _, c0 in _chunks(Rk):
            s = qs @ _rows(k, c0, _CHUNK).transpose(-1, -2) * (scale * _LOG2E) \
                + _mask_block(mask, G, q0, QT, c0, _CHUNK)[None] * _LOG2E
            s[..., max(0, Rk - c0):] = -torch.inf
            mn = torch.maximum(m, s.amax(-1))
            mu = torch.where(mn == -torch.inf, 0.0, mn)
            e = torch.exp2(s - mu[..., None])
            corr = torch.exp2(m - mu)
            l = l * corr + e.sum(-1)
            o = o * corr[..., None] + e @ _rows(v, c0, _CHUNK)
            m = mn
        out[:, :, q0:q0 + QT] = (o / l[..., None])[:, :, :Rq - q0]
    return out


def _b6b_model(g, q, k, v, mask, scale):
    """B6b's two tensor-core kernels.  Query side: pass one over 16-key
    chunks keeps the online max, sum and sum of P dP (row max m, log-sum
    ls, D), pass two forms dS = P (dP - D) with P = exp((S - m) - ls) and
    sums dq.  Key side: 64-key tiles walk the 64-query tiles in 16-query
    chunks with the mask read transposed, S^T = K Q^T + mask^T,
    dv += P^T G, dk += dS^T Q."""
    h, G, Rq, hd = q.shape
    Rk = k.shape[2]
    QT = _q_rows(Rq)
    dq = torch.empty_like(q)
    stats = torch.empty(3, h, G, Rq)  # m, ls, D
    for q0 in range(0, Rq, QT):
        qs, gs = _rows(q, q0, QT), _rows(g, q0, QT)
        m = torch.full((h, G, QT), -torch.inf)
        l, pd = torch.zeros(h, G, QT), torch.zeros(h, G, QT)
        acc = torch.zeros(h, G, QT, hd)

        def logits(c0):
            s = qs @ _rows(k, c0, _CHUNK).transpose(-1, -2) * scale \
                + _mask_block(mask, G, q0, QT, c0, _CHUNK)[None]
            s[..., max(0, Rk - c0):] = -torch.inf
            return s, gs @ _rows(v, c0, _CHUNK).transpose(-1, -2)

        for _, c0 in _chunks(Rk):
            s, dp = logits(c0)
            mn = torch.maximum(m, s.amax(-1))
            mu = torch.where(mn == -torch.inf, 0.0, mn)
            corr = torch.exp(m - mu)
            e = torch.exp(s - mu[..., None])
            l = l * corr + e.sum(-1)
            pd = pd * corr + (e * dp).sum(-1)
            m = mn
        ls, D = torch.log(l), pd / l
        for _, c0 in _chunks(Rk):
            s, dp = logits(c0)
            P = torch.exp((s - m[..., None]) - ls[..., None])
            acc += P * (dp - D[..., None]) @ _rows(k, c0, _CHUNK)
        n = Rq - q0
        dq[:, :, q0:q0 + QT] = (acc * scale)[:, :, :n]
        stats[:, :, :, q0:q0 + QT] = torch.stack((m, ls, D))[..., :n]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, Rk, _TILE):
        ks, vs = _rows(k, k0, _TILE), _rows(v, k0, _TILE)
        dka, dva = torch.zeros(h, G, _TILE, hd), torch.zeros(h, G, _TILE, hd)
        for _, i0 in _chunks(Rq):
            qc, gc = _rows(q, i0, _CHUNK), _rows(g, i0, _CHUNK)
            mT = _mask_block(mask, G, i0, _CHUNK, k0, _TILE).transpose(-1, -2)
            sT = ks @ qc.transpose(-1, -2) * scale + mT[None]  # [h, G, keys, queries]
            sm, sls, sD = (_rows(x[..., None], i0, _CHUNK)[..., 0] for x in stats)
            PT = torch.exp((sT - sm[:, :, None]) - sls[:, :, None])
            PT[..., max(0, Rq - i0):] = 0.0
            dST = PT * (vs @ gc.transpose(-1, -2) - sD[:, :, None])
            dva += PT @ gc
            dka += dST @ qc
        n = min(_TILE, Rk - k0)
        dk[:, :, k0:k0 + n] = (dka * scale)[:, :, :n]
        dv[:, :, k0:k0 + n] = dva[:, :, :n]
    return dq, dk, dv


def _tiling_inputs(Gm, seed):
    """Ragged shapes (Rq 40 = 48-row block, Rk 72 = 64 + 8 keys), hd 16,
    random masks with -1e9 entries and one query row masked everywhere."""
    h, G, Rq, Rk, hd = 2, 3, 40, 72, 16
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(h, G, Rq, hd).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(h, G, Rk, hd).astype(np.float32) for _ in range(2))
    mask = np.where(rng.rand(Gm, Rq, Rk) < 0.3, -1e9,
                    rng.randn(Gm, Rq, Rk)).astype(np.float32)
    mask[:, 5] = -1e9
    return q, k, v, mask, g, hd ** -0.5


@pytest.mark.parametrize("Gm", [1, 3])
def test_b6_tiling_model_matches_plain_and_jax(Gm):
    q, k, v, mask, _, scale = _tiling_inputs(Gm, seed=3)
    got = _b6_model(*(torch.from_numpy(x) for x in (q, k, v, mask)), scale)
    want = A.masked_attention_plain(*(torch.from_numpy(x) for x in (q, k, v, mask)),
                                    scale)
    torch.testing.assert_close(got, want, **TOL)
    jq, jk, jv, jm = (jnp.asarray(x) for x in (q, k, v, mask))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(fa.masked_attention(jq, jk, jv, jm, scale,
                                                    interpret=True)), **TOL)


@pytest.mark.parametrize("Gm", [1, 3])
def test_b6b_tiling_model_matches_plain_and_jax(Gm):
    q, k, v, mask, g, scale = _tiling_inputs(Gm, seed=4)
    got = _b6b_model(*(torch.from_numpy(x) for x in (g, q, k, v, mask)), scale)
    want = A.masked_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (g, q, k, v, mask)), scale)
    jm = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda q, k, v: fa.masked_attention_op(q, k, v, jm, scale),
                     *(jnp.asarray(x) for x in (q, k, v)))
    for name, a, b, c in zip("qkv", got, want, vjp(jnp.asarray(g))):
        torch.testing.assert_close(a, b, msg=name, **TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), err_msg=name, **TOL)
