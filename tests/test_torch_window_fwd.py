"""The forward of the window attention (K1) as its tensor-core kernel forms
it, in float32 on the CPU, against the port's plain version and the JAX
Pallas B1 in interpret mode.

``csrc/window_attention.cu``'s bf16 kernel does not compute the logits and
the value-table term the way ``window_attention_plain`` does, so its
formulation is written out here in torch f32 (``_tensor_core_form``):

* qr and kr are products of Q and K against every row of the
  relative-position table ([T, (2wh-1)(2ww-1)]), each then gathered to the
  key (or query) pixel whose relative index is that row;
* the softmax runs over 16-key chunks with an online max: the running sum
  and O are rescaled when the max grows, and each chunk's attention mass
  per key pixel (its N key columns summed) is kept beside the running max
  after the chunk, then rescaled to the final max;
* the value-table term is one product Wm VE, Wm[i, t] = mass(i, s) where
  rel(pix(i), s) = t, gathered through ``_w_index`` (B7's W matrices);
* out = (P V + Wm VE) / sum.

Inference (ws 6, N 4, candidate mask, T 144: 9 chunks) and Refinement
(ws 4, N 1, T 16: one chunk) windows, both shifts, and tiles of a taller
image (row0 > 0, hp_total > Hp, shifted).  atol = rtol = 1e-5: the same
f32 function in another summation order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nmrf_tpu.models.nmp import _relative_position_index
from nmrf_tpu.ops.pallas import attention as fa
from nmrf_tpu_torch.ops import attention as A

from .test_torch_fused_pos import _w_index

TOL = dict(atol=1e-5, rtol=1e-5)
HEADS, DIM = 2, 64  # head dim 32, the main path's
CHUNK = 16          # keys per chunk: the mma tile's n extent

# (B, H, W, N, ws, shift, candidate_mask, row0, hp_total)
CASES = {
    "inference/shift0": (1, 12, 12, 4, 6, 0, True, 0, None),
    "inference/shift3": (1, 12, 12, 4, 6, 3, True, 0, None),
    "refinement/shift0": (2, 8, 12, 1, 4, 0, False, 0, None),
    "refinement/shift2": (2, 8, 12, 1, 4, 2, False, 0, None),
    "inference tile1/shift3": (1, 12, 12, 4, 6, 3, True, 12, 24),
    "refinement tile2/shift2": (2, 8, 12, 1, 4, 2, False, 16, 24),
}


def _inputs(case):
    B, H, W, N, ws, *_ = CASES[case]
    rng = np.random.RandomState(14)
    qkv = rng.randn(B, H, W, N, 3 * DIM).astype(np.float32)
    table = (0.5 * rng.randn((2 * ws - 1) ** 2, 3 * DIM)).astype(np.float32)
    return qkv, table


def _tensor_core_form(qkv, table, shift, ws, heads, cand, row0, hp_total):
    """K1's output as the tensor-core kernel forms it (module docstring)."""
    B, Hp, Wp, N, C3 = qkv.shape
    h, hd = heads, C3 // (3 * heads)
    P, trows = ws * ws, (2 * ws - 1) ** 2
    T = P * N
    assert T % CHUNK == 0 and CHUNK % N == 0
    scale = hd ** -0.5
    q, k, v = A._window_split(qkv, (ws, ws), h, 3)  # [G, h, T, hd]
    G = q.shape[0]
    tab = table.reshape(trows, h, 3, hd)  # columns (head, component, hd)
    QE, KE, VE = tab[:, :, 0], tab[:, :, 1], tab[:, :, 2]
    pix = torch.arange(T) // N
    rel = torch.as_tensor(A.relative_position_index(ws, ws))  # [P, P]: rel(p, s)

    # positional blocks: every table row, then gathered by rel
    q_rows = torch.einsum("ghic,thc->ghit", q, KE) * scale
    k_rows = torch.einsum("ghjc,thc->ghjt", k, QE) * scale
    qr = torch.gather(q_rows, -1, rel[pix].expand(G, h, T, P))        # [.., i, s]
    kr = torch.gather(k_rows, -1, rel[:, pix].T.expand(G, h, T, P))   # [.., j, p]
    mask = torch.as_tensor(A._window_mask(Hp, Wp, ws, ws, N, shift, cand, row0,
                                          hp_total))
    logits = (q @ k.transpose(-1, -2) * scale + qr[..., pix]
              + kr[..., pix].transpose(-1, -2))
    logits = (logits.reshape(B, -1, h, T, T) + mask[None, :, None]).reshape(G, h, T, T)

    # one sweep over 16-key chunks, online softmax
    mx = torch.full((G, h, T, 1), -torch.inf)
    total = torch.zeros(G, h, T, 1)
    o = torch.zeros(G, h, T, hd)
    chunks = []
    for j0 in range(0, T, CHUNK):
        s = logits[..., j0:j0 + CHUNK]
        mn = torch.maximum(mx, s.amax(-1, keepdim=True))
        alpha = torch.exp(mx - mn)
        e = torch.exp(s - mn)
        total = total * alpha + e.sum(-1, keepdim=True)
        o = o * alpha + e @ v[:, :, j0:j0 + CHUNK]
        chunks.append((e.reshape(G, h, T, CHUNK // N, N).sum(-1), mn))
        mx = mn
    mass = torch.cat([m * torch.exp(c_mx - mx) for m, c_mx in chunks], -1)  # [.., i, s]

    # value-table term: Wm VE through the gathered W index
    q_idx, _ = _w_index(ws)
    padded = torch.cat([mass, mass.new_zeros(G, h, T, 1)], -1)
    Wm = torch.gather(padded, -1, torch.as_tensor(q_idx[pix.numpy()]).expand(G, h, T, trows))
    o = (o + torch.einsum("ghit,thc->ghic", Wm, VE)) / total
    return A._window_merge(o[None], (B, Hp, Wp, N), (ws, ws))


def _jax_pallas_b1(qkv, table, shift, ws, N, heads, cand, row0, hp_total):
    """The JAX Pallas B1 (``window_attention_native``) in interpret mode, its
    positional blocks and value table gathered from one rel_table as the JAX
    ``WindowAttention`` gathers them (``nmp.py:242-245,292-305``)."""
    P, hd = ws * ws, qkv.shape[-1] // (3 * heads)
    scale = hd ** -0.5
    WB = fa.choose_column_block(qkv.shape[2] // ws, P * N)
    pixs = fa.window_meta(ws, ws, WB, N)[0][:, 0]
    rel_index = _relative_position_index(ws, ws)
    qkv, table = jnp.asarray(qkv), jnp.asarray(table)
    rpe = table[rel_index.reshape(-1)].reshape(P, P, heads, 3 * hd)
    q_embed, k_embed, v_embed = jnp.split(rpe, 3, axis=-1)
    qr, kr = fa.window_positional_terms(qkv, k_embed, q_embed, scale, ws, ws,
                                        WB, heads)
    ve_flat = v_embed.transpose(2, 0, 3, 1)[:, pixs].reshape(heads, len(pixs),
                                                             hd * P)
    return np.asarray(fa.window_attention_native(
        qkv, qr, kr, ve_flat, shift, scale, ws, ws, WB, heads, cand,
        interpret=True, row0=row0, hp_total=qkv.shape[1] if hp_total is None
        else hp_total))


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_core_form_matches_plain(case):
    B, H, W, N, ws, shift, cand, row0, hp_total = CASES[case]
    qkv, table = (torch.from_numpy(x) for x in _inputs(case))
    got = _tensor_core_form(qkv, table, shift, ws, HEADS, cand, row0, hp_total)
    want = A.window_attention_plain(qkv, table, shift, (ws, ws), HEADS, cand,
                                    row0, hp_total)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_core_form_matches_jax_pallas_b1(case):
    B, H, W, N, ws, shift, cand, row0, hp_total = CASES[case]
    qkv, table = _inputs(case)
    got = _tensor_core_form(torch.from_numpy(qkv), torch.from_numpy(table),
                            shift, ws, HEADS, cand, row0, hp_total)
    want = _jax_pallas_b1(qkv, table, shift, ws, N, HEADS, cand, row0, hp_total)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
