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
  gradients as with the flag.

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


@pytest.mark.parametrize("case", list(_OP_CASES))
def test_b7_plain_matches_jax_pallas_b7(case, b7_calls):
    B, H, W, N, ws, shift, cand, row0, hp_total = _OP_CASES[case]
    dim, heads = 16, 2
    rng = np.random.RandomState(12)
    qkv = _rand(rng, B, H, W, N, 3 * dim)
    table = 0.1 * _rand(rng, (2 * ws - 1) ** 2, 3 * dim)
    g = _rand(rng, B, H, W, N, dim)
    out_want, grads_want = _jax_pos_op_vjp(qkv, table, g, shift, ws, N, heads,
                                           cand, row0, hp_total)
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
