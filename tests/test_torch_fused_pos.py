"""The fused-positional window backward (B7, ``NMRF_FUSED_POS=1``) of the
port against the JAX package (CPU, float32).

* (a) B7's plain version ``window_attention_pos_bwd_plain`` (and the
  wrapper, which takes it for CPU tensors) against ``jax.vjp`` of the JAX
  ``window_attention_pos_op``, whose backward is the Pallas B7 in interpret
  mode; the JAX op's tables are gathered from one rel_table as the JAX
  ``WindowAttention`` gathers them (``nmp.py:242-245,292-293``), so d(table)
  compares directly.  Inference (ws 6, N 4, candidate mask) and Refinement
  (ws 4, N 1) windows, both shifts, and a tile of a taller image (row0 =
  Hp of hp_total = 2 Hp, shifted).  atol = rtol = 2e-5, the JAX package's
  own tolerance for this op (``tests/test_pallas.py:290-295``);
* (b) ``WindowAttention`` gradients with the flag set (the port's kernel
  path on the CPU: the plain forward, B7's plain version as the backward)
  against the JAX ``WindowAttention`` on its Pallas path with the flag,
  atol = rtol = 1e-4 as ``tests/test_torch_grads.py``;
* (c) one whole training step with the flag against the JAX step on its
  Pallas path with the flag, at ``tests/test_torch_train.py``'s tolerances;
* (d) with the flag unset the port takes K1b's path as before: no call of
  B7's plain version, no launch counted, and the same output and
  gradients as with the flag;
* (e) the product form of B7's tensor-core kernel: the positional backward
  as five dense products with [T, (2ws-1)^2] matrices Wq, Wk and Wm,
  gathered from the plain dqr, dkr and mass through the relative index the
  kernel uses (``w_col`` in ``csrc/window_attention_pos_bwd.cu``), in f32,
  against B7's plain version and the JAX Pallas B7 at (a)'s 2e-5.

JAX reads ``NMRF_FUSED_POS`` when it traces, so each test sets it with
``monkeypatch.setenv`` before it builds and jits a fresh function.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nmrf_tpu.config import get_cfg as get_cfg_jax
from nmrf_tpu.models import build_model as build_model_jax
from nmrf_tpu.models import nmp as nmp_jax
from nmrf_tpu.models.nmp import NEG_INF, _relative_position_index
from nmrf_tpu.ops.pallas import attention as fa
from nmrf_tpu_torch.models import nmp
from nmrf_tpu_torch.ops import attention as A

from .test_torch_grads import _jax_grads, _port_grads
from .test_torch_modules import TOL, _load, _rand
from .test_torch_train import (MIN_MARGIN, _leaves, _port_model,
                               _port_step_grads, _small)
from .test_torch_train import batch, jax_params  # noqa: F401  (fixtures)


@pytest.fixture
def b7_calls(monkeypatch):
    """Count the calls of B7's plain version (the port's backward on CPU
    tensors with the flag) and of the JAX ``window_attention_pos_op``."""
    calls = {"port": 0, "jax": 0}
    port_plain = A.window_attention_pos_bwd_plain
    jax_op = fa.window_attention_pos_op

    def port(*args, **kw):
        calls["port"] += 1
        return port_plain(*args, **kw)

    def jax_fn(*args, **kw):
        calls["jax"] += 1
        return jax_op(*args, **kw)

    monkeypatch.setattr(A, "window_attention_pos_bwd_plain", port)
    monkeypatch.setattr(fa, "window_attention_pos_op", jax_fn)
    return calls


# ---- (a) ---- #

# (B, H, W, N, ws, shift, candidate_mask, row0, hp_total)
_OP_CASES = {
    "inference/shift0": (1, 12, 12, 4, 6, 0, True, 0, 12),
    "inference/shift3": (1, 12, 12, 4, 6, 3, True, 0, 12),
    "refinement/shift0": (2, 8, 12, 1, 4, 0, False, 0, 8),
    "refinement/shift2": (2, 8, 12, 1, 4, 2, False, 0, 8),
    "inference tile1/shift3": (1, 12, 12, 4, 6, 3, True, 12, 24),
}


def _jax_pos_op_vjp(qkv, table, g, shift, ws, N, heads, cand, row0, hp_total):
    """Output and (d(qkv), d(table)) of the JAX fused-positional op on the
    tables of ``rel_table``, gathered as the JAX ``WindowAttention`` does."""
    P, hd = ws * ws, qkv.shape[-1] // (3 * heads)
    WB = fa.choose_column_block(qkv.shape[2] // ws, P * N)
    pixs = fa.window_meta(ws, ws, WB, N)[0][:, 0]
    rel_index = _relative_position_index(ws, ws)

    def f(qkv, table):
        rpe = table[rel_index.reshape(-1)].reshape(P, P, heads, 3 * hd)
        q_embed, k_embed, v_embed = jnp.split(rpe, 3, axis=-1)
        ve_flat = v_embed.transpose(2, 0, 3, 1)[:, pixs].reshape(
            heads, len(pixs), hd * P)
        return fa.window_attention_pos_op(
            qkv, k_embed, q_embed, ve_flat, shift, row0, hd ** -0.5, ws, ws,
            WB, heads, cand, NEG_INF, hp_total, False)

    out, vjp = jax.vjp(f, jnp.asarray(qkv), jnp.asarray(table))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


_OP_HEADS = 2
_OP_RESULTS = {}


def _op_case(case):
    """Inputs (qkv, table, g) of an _OP_CASES case, 16 channels in 2 heads,
    and the JAX fused-positional op's output and (d(qkv), d(table)) on them,
    kept for the process: (e) reuses what (a) computed."""
    if case in _OP_RESULTS:
        return _OP_RESULTS[case]
    B, H, W, N, ws, shift, cand, row0, hp_total = _OP_CASES[case]
    dim = 16
    rng = np.random.RandomState(12)
    qkv = _rand(rng, B, H, W, N, 3 * dim)
    table = 0.1 * _rand(rng, (2 * ws - 1) ** 2, 3 * dim)
    g = _rand(rng, B, H, W, N, dim)
    out, grads = _jax_pos_op_vjp(qkv, table, g, shift, ws, N, _OP_HEADS, cand,
                                 row0, hp_total)
    _OP_RESULTS[case] = (qkv, table, g), out, grads
    return _OP_RESULTS[case]


@pytest.mark.parametrize("case", list(_OP_CASES))
def test_b7_plain_matches_jax_pallas_b7(case, b7_calls):
    B, H, W, N, ws, shift, cand, row0, hp_total = _OP_CASES[case]
    heads = _OP_HEADS
    _OP_RESULTS.pop(case, None)  # this test counts the JAX call
    (qkv, table, g), out_want, grads_want = _op_case(case)
    assert b7_calls["jax"] == 1
    args = (torch.from_numpy(qkv), torch.from_numpy(table), shift, (ws, ws),
            heads, cand, row0, hp_total)
    out = A.window_attention_plain(*args)
    np.testing.assert_allclose(out.numpy(), out_want, atol=2e-5, rtol=2e-5)
    got = A.window_attention_pos_bwd_plain(torch.from_numpy(g), *args)
    via_wrapper = A.window_attention_pos_bwd(torch.from_numpy(g), *args)
    assert b7_calls["port"] == 2
    for name, a, w, b in zip(("qkv", "table"), got, via_wrapper, grads_want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5, rtol=2e-5,
                                   err_msg=name)
        torch.testing.assert_close(w, a, atol=0, rtol=0)


# ---- (b) ---- #

@pytest.mark.parametrize("setting", ["inference", "refinement"])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_grads_with_the_flag(setting, shifted, monkeypatch,
                                              b7_calls):
    """d(qkv) and d(table) of WindowAttention with NMRF_FUSED_POS=1, the
    JAX side on its Pallas path (``window_attention_pos_op``)."""
    monkeypatch.setenv("NMRF_FUSED_POS", "1")
    ws, N, cand = (6, 4, True) if setting == "inference" else (4, 1, False)
    shift = ws // 2 if shifted else 0
    dim, heads = 16, 2
    H, W = 2 * ws, 3 * ws
    rng = np.random.RandomState(13)
    qkv = _rand(rng, 2, H, W, N, 3 * dim)
    R = _rand(rng, 2, H, W, N, dim)
    jm = nmp_jax.WindowAttention(dim, (ws, ws), shift, heads, use_pallas=True,
                                 candidate_mask=cand)
    params = jm.init(jax.random.PRNGKey(0), qkv, None)
    pm = nmp.WindowAttention(dim, (ws, ws), heads, cand, use_kernels=True)
    params = _load(pm, params)
    gp, (gx,) = _jax_grads(lambda p, x: jm.apply(p, x, None), params, [qkv], R)
    assert b7_calls["jax"] >= 1
    (got,) = _port_grads(pm, [qkv], R, shift)
    assert b7_calls["port"] == 1
    np.testing.assert_allclose(got, np.asarray(gx), **TOL)
    np.testing.assert_allclose(
        pm.relative_position_enc_table.grad.numpy(),
        np.asarray(gp["params"]["relative_position_enc_table"]), **TOL)


# ---- (c) ---- #

def test_train_step_with_the_flag_matches_jax(jax_params, batch, monkeypatch,
                                              b7_calls):
    """One whole step, port and JAX (Pallas path) both with
    NMRF_FUSED_POS=1: loss terms at rtol 1e-5, every gradient leaf within
    1e-4 max|g_jax| + 1e-6 (``tests/test_torch_train.py``'s spread logits
    and raised head biases keep argmax ties and ReLU kinks away)."""
    monkeypatch.setenv("NMRF_FUSED_POS", "1")
    cfg = _small(get_cfg_jax(), use_pallas=True)
    cfg.freeze()
    model, criterion = build_model_jax(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out = model.apply(p, jb["img1"], jb["img2"], train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        losses = criterion(out, {"disp": jb["disp"], "valid": jb["valid"]})
        return losses["total"], (losses, out["logits_layers"][-1])

    (_, (losses, logits)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, jax_params))
    assert b7_calls["jax"] == 4  # 2 + 2 window layers, traced once
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MIN_MARGIN

    got_losses, got_grads = _port_step_grads(_port_model(jax_params), batch)
    assert b7_calls["port"] == 4
    assert set(got_losses) == set(losses)
    for key, value in losses.items():
        np.testing.assert_allclose(got_losses[key], float(value), rtol=1e-5,
                                   err_msg=key)
    want, got = _leaves(grads), _leaves(got_grads)
    assert want.keys() == got.keys()
    bad = []
    for key, g in want.items():
        bound = 1e-4 * np.abs(g).max() + 1e-6
        err = np.abs(got[key] - g).max()
        if err > bound:
            bad.append(f"{key}: |d| {err:.3e} > {bound:.3e}")
    assert not bad, "\n".join(bad)


# ---- (d) ---- #

@pytest.mark.parametrize("setting", ["inference", "refinement"])
def test_flag_unset_keeps_the_default_path(setting, monkeypatch, b7_calls):
    """Without the flag WindowAttention differentiates the plain forward
    (K1b's path on the card) and never calls B7's plain version; with it,
    the same output, the same gradients to 1e-5, one B7 call.  No launch
    is counted on the CPU either way, and every wrapper of the port,
    B7's included, reports its count."""
    ws, N, cand = (6, 4, True) if setting == "inference" else (4, 1, False)
    rng = np.random.RandomState(14)
    qkv = _rand(rng, 2, 2 * ws, 3 * ws, N, 48)
    R = torch.from_numpy(_rand(rng, 2, 2 * ws, 3 * ws, N, 16))
    pm = nmp.WindowAttention(16, (ws, ws), 2, cand, use_kernels=True)
    with torch.no_grad():
        pm.relative_position_enc_table.copy_(torch.from_numpy(
            _rand(rng, (2 * ws - 1) ** 2, 48)))
    A.reset_launch_counts()
    results = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("NMRF_FUSED_POS", flag)
        pm.zero_grad(set_to_none=True)
        x = torch.from_numpy(qkv).requires_grad_()
        out = pm(x, ws // 2)
        (out * R).sum().backward()
        results[flag] = (out.detach(), x.grad, pm.relative_position_enc_table.grad)
        assert b7_calls["port"] == (flag == "1")
    torch.testing.assert_close(results["0"][0], results["1"][0], atol=0, rtol=0)
    for a, b in zip(results["0"][1:], results["1"][1:]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert A.launch_counts() == dict.fromkeys(
        ("window_attention", "stripe_attention", "window_attention_bwd",
         "stripe_attention_bwd", "msda_taps", "masked_attention",
         "masked_attention_bwd", "window_attention_pos_bwd"), 0)


# ---- (e) ---- #

def _w_index(ws):
    """([P, trows], [P, trows]) for pixel p of a ws x ws window and table row
    t = (dy, dx), dy = t // (2ws-1): the key pixel s with rel(p, s) = t (the
    query side: Wq, Wm) and the query pixel s' with rel(s', p) = t (the key
    side: Wk), P (an appended zero column) where no pixel matches, as the
    kernel's ``w_col`` finds them."""
    P, W2 = ws * ws, 2 * ws - 1
    q_idx = np.full((P, W2 * W2), P)
    k_idx = np.full((P, W2 * W2), P)
    for p in range(P):
        y, x = divmod(p, ws)
        for t in range(W2 * W2):
            dy, dx = divmod(t, W2)
            for idx, sy, sx in ((q_idx, y + ws - 1 - dy, x + ws - 1 - dx),
                                (k_idx, y - ws + 1 + dy, x - ws + 1 + dx)):
                if 0 <= sy < ws and 0 <= sx < ws:
                    idx[p, t] = sy * ws + sx
    return q_idx, k_idx


def _product_form_bwd(g, qkv, table, shift, ws, heads, cand, row0, hp_total):
    """(d(qkv), d(table)) of the window attention, f32: the softmax
    backward written out as in B7's plain version, then the positional
    backward as the tensor-core kernel forms it, five products with the
    gathered W matrices:
        dq += scale Wq KE,  dk += scale Wk QE,
        d(table)[q cols] = scale Wk^T K, [k cols] = scale Wq^T Q,
        [v cols] = Wm^T G."""
    B, Hp, Wp, N, C3 = qkv.shape
    h, hd = heads, C3 // (3 * heads)
    P, trows = ws * ws, (2 * ws - 1) ** 2
    scale = hd ** -0.5
    q, k, v = A._window_split(qkv, (ws, ws), h, 3)
    (gw,) = A._window_split(g, (ws, ws), h, 1)
    qe, ke, ve = A._window_tables(table, (ws, ws), h)
    attn = A._window_probs(q, k, qe, ke, (B, Hp, Wp, N), (ws, ws), shift, cand,
                           row0, hp_total)
    G, _, T, _ = q.shape
    gve = torch.einsum("ghpnc,pshc->ghpns", gw.reshape(G, h, P, N, hd), ve)
    dattn = gw @ v.transpose(-1, -2) \
        + gve.reshape(G, h, T, P).repeat_interleave(N, dim=-1)
    dS = attn * (dattn - (dattn * attn).sum(-1, keepdim=True))
    dqr = dS.reshape(G, h, T, P, N).sum(-1)
    dkr = dS.transpose(-1, -2).reshape(G, h, T, P, N).sum(-1)
    mass = attn.reshape(G, h, T, P, N).sum(-1)

    q_idx, k_idx = _w_index(ws)
    pix = np.arange(T) // N

    def gathered(block, idx):  # [G, h, T, P] -> [G, h, T, trows]
        padded = torch.cat([block, block.new_zeros(G, h, T, 1)], dim=-1)
        index = torch.as_tensor(idx[pix]).expand(G, h, T, trows)
        return torch.gather(padded, -1, index)

    Wq, Wk, Wm = gathered(dqr, q_idx), gathered(dkr, k_idx), gathered(mass, q_idx)
    tab = table.reshape(trows, h, 3, hd)
    QE, KE = tab[:, :, 0], tab[:, :, 1]
    dq = (dS @ k + torch.einsum("ghit,thc->ghic", Wq, KE)) * scale
    dk = (dS.transpose(-1, -2) @ q + torch.einsum("ghjt,thc->ghjc", Wk, QE)) * scale
    dv = attn.transpose(-1, -2) @ gw
    d_table = torch.stack([
        torch.einsum("ghjt,ghjc->thc", Wk, k) * scale,
        torch.einsum("ghit,ghic->thc", Wq, q) * scale,
        torch.einsum("ghit,ghic->thc", Wm, gw)], dim=2)
    dqkv = A._window_merge(torch.stack([dq, dk, dv]), (B, Hp, Wp, N), (ws, ws))
    return dqkv, d_table.reshape(trows, C3)


@pytest.mark.parametrize("case", ["inference/shift0", "inference/shift3",
                                  "refinement/shift0", "refinement/shift2"])
def test_b7_product_form_matches_plain_and_jax(case):
    B, H, W, N, ws, shift, cand, row0, hp_total = _OP_CASES[case]
    # the W index is the relative-position index turned inside out
    q_idx, k_idx = _w_index(ws)
    rel = A.relative_position_index(ws, ws)
    P = ws * ws
    for p in range(P):
        np.testing.assert_array_equal(q_idx[p, rel[p]], np.arange(P))
        np.testing.assert_array_equal(k_idx[p, rel[:, p]], np.arange(P))
    assert ((q_idx < P).sum(1) == P).all() and ((k_idx < P).sum(1) == P).all()

    (qkv, table, g), _, grads_want = _op_case(case)
    args = (torch.from_numpy(qkv), torch.from_numpy(table), shift, (ws, ws),
            _OP_HEADS, cand, row0, hp_total)
    got = _product_form_bwd(torch.from_numpy(g), torch.from_numpy(qkv),
                            torch.from_numpy(table), shift, ws, _OP_HEADS,
                            cand, row0, hp_total)
    plain = A.window_attention_pos_bwd_plain(torch.from_numpy(g), *args)
    for name, a, b, w in zip(("qkv", "table"), got, plain, grads_want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5,
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), w, atol=2e-5, rtol=2e-5,
                                   err_msg=name)
