"""Gradients of the port's attention modules and stages against ``jax.grad``
through the JAX package's flax modules (CPU, float32), and the plain
backward versions of the kernels against autograd of their plain forward
versions.

The JAX side runs its Pallas path (the forward and backward kernels in
interpret mode on the CPU, through their custom VJPs) and its XLA path.  The
loss is sum(out * R) for a fixed random R.  Tolerances: modules and stages
atol = rtol = 1e-4 (the same f32 math in another summation order); the
plain backward versions against autograd atol 1e-5, rtol 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nmrf_tpu.models import nmp as nmp_jax
from nmrf_tpu.models import stages as stages_jax
from nmrf_tpu.models.nmp import shift_window_attn_mask, window_attn_mask
from nmrf_tpu_torch.models import nmp, stages
from nmrf_tpu_torch.ops import _native
from nmrf_tpu_torch.ops import attention as A

from .test_torch_modules import TOL, _load, _rand


def _jax_grads(apply, params, inputs, R):
    """d sum(apply(params, *inputs) * R) / d(params, inputs), jitted."""

    def loss(p, xs):
        return (apply(p, *xs) * R).sum()

    return jax.jit(jax.grad(loss, argnums=(0, 1)))(
        params, [jnp.asarray(x) for x in inputs])


def _port_grads(module, inputs, R, *extra):
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    (module(*xs, *extra) * torch.from_numpy(R)).sum().backward()
    return [x.grad.numpy() for x in xs]


def _check_param_grads(module, jax_param_grads):
    """Every parameter gradient of the port module against the flax tree
    (matched through the state-dict key of each leaf)."""
    from nmrf_tpu_torch.utils.convert import params_from_jax

    want = params_from_jax({"m": jax.tree_util.tree_map(
        np.asarray, jax_param_grads["params"])})
    got = {f"m.{k}": p.grad for k, p in module.named_parameters()}
    assert want.keys() == got.keys()
    for key, g in want.items():
        np.testing.assert_allclose(got[key].numpy(), g.numpy(), **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("setting", ["inference", "refinement"])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_grads(setting, shifted, use_pallas):
    """d(qkv) and d(table) of WindowAttention: Inference (ws 6, N 4,
    candidate mask) and Refinement (ws 4, N 1), both shifts, on a grid of
    2 x 3 windows with batch 2."""
    ws, N, cand = (6, 4, True) if setting == "inference" else (4, 1, False)
    shift = ws // 2 if shifted else 0
    dim, heads = 16, 2
    H, W = 2 * ws, 3 * ws
    rng = np.random.RandomState(6)
    qkv = _rand(rng, 2, H, W, N, 3 * dim)
    R = _rand(rng, 2, H, W, N, dim)
    if shifted:
        mask = shift_window_attn_mask((H, W), (ws, ws, N), shift,
                                      with_candidate_mask=cand)
    elif cand:
        mask = window_attn_mask((ws, ws, N))[None]
    else:
        mask = None
    mask = None if mask is None else jnp.asarray(mask)
    jm = nmp_jax.WindowAttention(dim, (ws, ws), shift, heads,
                                 use_pallas=use_pallas, candidate_mask=cand)
    params = jm.init(jax.random.PRNGKey(0), qkv, mask)
    pm = nmp.WindowAttention(dim, (ws, ws), heads, cand, use_kernels=True)
    params = _load(pm, params)

    gp, (gx,) = _jax_grads(lambda p, x: jm.apply(p, x, mask), params, [qkv], R)
    (got,) = _port_grads(pm, [qkv], R, shift)
    np.testing.assert_allclose(got, np.asarray(gx), **TOL)
    np.testing.assert_allclose(
        pm.relative_position_enc_table.grad.numpy(),
        np.asarray(gp["params"]["relative_position_enc_table"]), **TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("idx", [0, 1])
def test_cswin_attention_grads(idx, use_pallas):
    """d(q, k, v) and d(positional conv) of CSWinAttention, both stripe
    directions, split 2 on odd sizes (padded stripes)."""
    rng = np.random.RandomState(7)
    q, k, v = (_rand(rng, 2, 7, 9, 3, 16) for _ in range(3))
    R = _rand(rng, 2, 7, 9, 3, 16)
    jm = nmp_jax.CSWinAttention(16, idx=idx, split_size=2, num_heads=2,
                                use_pallas=use_pallas)
    params = jm.init(jax.random.PRNGKey(0), q, k, v)
    pm = nmp.CSWinAttention(16, idx=idx, split_size=2, num_heads=2,
                            use_kernels=True)
    params = _load(pm, params)
    gp, gx = _jax_grads(jm.apply, params, [q, k, v], R)
    got = _port_grads(pm, [q, k, v], R)
    for name, a, b in zip("qkv", got, gx):
        np.testing.assert_allclose(a, np.asarray(b), **TOL, err_msg=name)
    np.testing.assert_allclose(pm.get_v.weight.grad.numpy(),
                               np.asarray(gp["params"]["get_v_kernel"])
                               .transpose(3, 2, 0, 1), **TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("stage", ["inference", "refinement"])
def test_stage_grads_with_window_padding(stage, use_pallas):
    """Every parameter gradient and the feature-map gradients of the
    Inference/Refinement stage in train mode (all layers' outputs), 2 layers
    (both shift parities), on grids that need centered window padding."""
    rng = np.random.RandomState(8)
    if stage == "inference":
        H, W, N, ws = 8, 10, 4, 6
        labels = rng.uniform(0, 6, (2, H, W, N)).astype(np.float32)
    else:
        H, W, N, ws = 7, 10, 1, 4
        labels = rng.uniform(0, 6, (2, H, W)).astype(np.float32)
    fmaps = [_rand(rng, 2, H, W, 8), _rand(rng, 2, H, W, 8),
             _rand(rng, 2, H, W, 16), _rand(rng, 2, H, W, 16)]
    cls_jax = stages_jax.Inference if stage == "inference" else stages_jax.Refinement
    jm = cls_jax(cost_group=4, dim=16, num_layers=2, mlp_ratio=2.0,
                 window_size=ws, n_heads=2, normalize_before=True,
                 return_intermediate=True, use_pallas=use_pallas)
    params = jm.init(jax.random.PRNGKey(0), labels, *fmaps)
    cls = stages.Inference if stage == "inference" else stages.Refinement
    pm = cls(8, 4, 16, 2, 2.0, ws, 2, normalize_before=True, use_kernels=True,
             return_intermediate=True)
    params = _load(pm, params)
    pm.train()
    out_shape = (2, 2, H, W) + ((N,) if stage == "inference" else ()) + (16,)
    R = _rand(rng, *out_shape)

    gp, gx = _jax_grads(
        lambda p, *xs: jm.apply(p, labels, *xs, deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(0)}),
        params, fmaps, R)
    got = _port_grads(lambda *xs: pm(torch.from_numpy(labels), *xs), fmaps, R)
    for i, (a, b) in enumerate(zip(got, gx)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL, err_msg=f"fmap {i}")
    _check_param_grads(pm, gp)


_WINDOW_CASES = [(12, 18, 4, 6, 3, True), (12, 18, 4, 6, 0, True),
                 (8, 12, 1, 4, 2, False), (8, 12, 1, 4, 0, False)]


@pytest.mark.parametrize("case", _WINDOW_CASES)
def test_window_bwd_plain_matches_autograd(case):
    Hp, Wp, N, ws, shift, cand = case
    rng = np.random.RandomState(9)
    qkv = torch.from_numpy(_rand(rng, 2, Hp, Wp, N, 48)).requires_grad_()
    table = torch.from_numpy(0.5 * _rand(rng, (2 * ws - 1) ** 2, 48))
    table.requires_grad_()
    g = torch.from_numpy(_rand(rng, 2, Hp, Wp, N, 16))
    out = A.window_attention_plain(qkv, table, shift, (ws, ws), 2, cand)
    want = torch.autograd.grad(out, (qkv, table), g)
    got = A.window_attention_bwd_plain(g, qkv.detach(), table.detach(), shift,
                                       (ws, ws), 2, cand)
    for name, a, b in zip(("qkv", "table"), got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.parametrize("H_sp,W_sp", [(6, 1), (1, 9), (3, 3)])
def test_stripe_bwd_plain_matches_autograd(H_sp, W_sp):
    rng = np.random.RandomState(10)
    q, k, v = (torch.from_numpy(_rand(rng, 2, 6, 9, 3, 32)).requires_grad_()
               for _ in range(3))
    g = torch.from_numpy(_rand(rng, 2, 6, 9, 3, 32))
    out = A.stripe_attention_plain(q, k, v, H_sp, W_sp, 2)
    want = torch.autograd.grad(out, (q, k, v), g)
    got = A.stripe_attention_bwd_plain(g, q.detach(), k.detach(), v.detach(),
                                       H_sp, W_sp, 2)
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)


def test_cpu_backward_wrappers_take_the_plain_versions():
    """On CPU tensors the backward wrappers return the plain versions'
    gradients and count no launch."""
    _native.reset_launch_counts()
    rng = np.random.RandomState(11)
    qkv = torch.from_numpy(_rand(rng, 1, 8, 8, 1, 24))
    table = torch.from_numpy(_rand(rng, 49, 24))
    g = torch.from_numpy(_rand(rng, 1, 8, 8, 1, 8))
    got = A.window_attention_bwd(g, qkv, table, 2, (4, 4), 2, False)
    want = A.window_attention_bwd_plain(g, qkv, table, 2, (4, 4), 2, False)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    q = torch.from_numpy(_rand(rng, 1, 4, 6, 2, 8))
    for a, b in zip(A.stripe_attention_bwd(q, q, q, q, 4, 1, 2),
                    A.stripe_attention_bwd_plain(q, q, q, q, 4, 1, 2)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert set(_native.launch_counts().values()) == {0}
