"""PyTorch port modules against the JAX package's flax modules (CPU).

The flax params (random, with seeded noise on every leaf so zero-initialised
tables and biases are exercised) go through ``params_from_jax`` into the
port module; both see the same numpy inputs.  The port runs through its
kernel wrappers (``use_kernels=True``, which take the plain versions for
CPU tensors) and through the plain versions directly
(``use_kernels=False``); the JAX side runs both its Pallas path (interpret
mode on the CPU) and its XLA path.  Tolerance: float32, atol = rtol = 1e-4
(the same f32 math in another summation order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nmrf_tpu.models import nmp as nmp_jax
from nmrf_tpu.models.nmp import shift_window_attn_mask, window_attn_mask
from nmrf_tpu_torch.models import nmp
from nmrf_tpu_torch.ops import attention as attn_ops
from nmrf_tpu_torch.utils.convert import params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)


def _load(module, params):
    """Noisy copy of a flax param tree -> port module (strict)."""
    rng = np.random.RandomState(11)
    noisy = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.randn(*x.shape).astype(np.float32),
        params["params"])
    state = {k[len("m."):]: v for k, v in params_from_jax({"m": noisy}).items()}
    module.load_state_dict(state, strict=True)
    return {"params": jax.tree_util.tree_map(jnp.asarray, noisy)}


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _port(module, *args):
    with torch.inference_mode():
        return module(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                        for a in args]).numpy()


@pytest.mark.parametrize("normalize_before", [True, False])
def test_basic_attention(normalize_before):
    rng = np.random.RandomState(0)
    x, enc = _rand(rng, 30, 4, 16), _rand(rng, 30, 4, 31)
    jm = nmp_jax.BasicAttention(16, 4, normalize_before=normalize_before)
    params = jm.init(jax.random.PRNGKey(0), x, enc)
    pm = nmp.BasicAttention(16, 31, 4, normalize_before)
    params = _load(pm, params)
    want = np.asarray(jm.apply(params, x, enc))
    np.testing.assert_allclose(_port(pm, x, enc), want, **TOL)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("setting", ["inference", "refinement"])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention(setting, shifted, use_pallas, use_kernels):
    """Inference (ws 6, N 4, candidate mask) and Refinement (ws 4, N 1)
    settings, both shifts, on a grid of 2 x 3 windows."""
    ws, N, cand = (6, 4, True) if setting == "inference" else (4, 1, False)
    shift = ws // 2 if shifted else 0
    dim, heads = 16, 2
    H, W = 2 * ws, 3 * ws
    rng = np.random.RandomState(1)
    qkv = _rand(rng, 1, H, W, N, 3 * dim)
    if shifted:
        mask = shift_window_attn_mask((H, W), (ws, ws, N), shift,
                                      with_candidate_mask=cand)
    elif cand:
        mask = window_attn_mask((ws, ws, N))[None]
    else:
        mask = None
    jm = nmp_jax.WindowAttention(dim, (ws, ws), shift, heads,
                                 use_pallas=use_pallas, pallas_interpret=True,
                                 candidate_mask=cand)
    params = jm.init(jax.random.PRNGKey(0), qkv, mask)
    pm = nmp.WindowAttention(dim, (ws, ws), heads, cand, use_kernels=use_kernels)
    params = _load(pm, params)
    want = np.asarray(jm.apply(params, qkv, None if mask is None
                               else jnp.asarray(mask)))
    with torch.inference_mode():
        got = pm(torch.from_numpy(qkv), shift).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("idx", [0, 1])
def test_cswin_attention(idx, use_pallas, use_kernels):
    """Both stripe orientations; split 2 on odd sizes pads the stripes."""
    rng = np.random.RandomState(2)
    q, k, v = (_rand(rng, 1, 7, 9, 3, 16) for _ in range(3))
    jm = nmp_jax.CSWinAttention(16, idx=idx, split_size=2, num_heads=2,
                                use_pallas=use_pallas, pallas_interpret=True)
    params = jm.init(jax.random.PRNGKey(0), q, k, v)
    pm = nmp.CSWinAttention(16, idx=idx, split_size=2, num_heads=2,
                            use_kernels=use_kernels)
    params = _load(pm, params)
    want = np.asarray(jm.apply(params, q, k, v))
    np.testing.assert_allclose(_port(pm, q, k, v), want, **TOL)


@pytest.mark.parametrize("v_dim", [16, 24])  # 24: Fourier v pos-embed
@pytest.mark.parametrize("normalize_before", [True, False])
def test_cswin_nmp(v_dim, normalize_before):
    rng = np.random.RandomState(3)
    tgt, ctx = _rand(rng, 1, 5, 8, 2, 16), _rand(rng, 1, 5, 8, 2, 8)
    if v_dim > 16:  # v input = tgt ++ Fourier grid: qk has the context
        ctx = None
    qk_dim = 16 if ctx is None else 24
    jm = nmp_jax.CSWinNMP(16, qk_dim, v_dim, 4, split_size=1,
                          normalize_before=normalize_before, use_pallas=True)
    params = jm.init(jax.random.PRNGKey(0), tgt, ctx)
    pm = nmp.CSWinNMP(16, qk_dim, v_dim, 4, split_size=1,
                      normalize_before=normalize_before, use_kernels=True)
    params = _load(pm, params)
    want = np.asarray(jm.apply(params, tgt, ctx))
    with torch.inference_mode():
        got = pm(torch.from_numpy(tgt),
                 None if ctx is None else torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_wrappers_do_not_count_launches():
    attn_ops.reset_launch_counts()
    rng = np.random.RandomState(5)
    qkv = torch.from_numpy(_rand(rng, 1, 8, 8, 1, 24))
    table = torch.from_numpy(_rand(rng, 49, 24))
    attn_ops.window_attention(qkv, table, 2, (4, 4), 2, False)
    q = torch.from_numpy(_rand(rng, 1, 4, 6, 2, 8))
    attn_ops.stripe_attention(q, q, q, 4, 1, 2)
    qh, kh = torch.from_numpy(_rand(rng, 2, 3, 4, 8)), torch.from_numpy(
        _rand(rng, 2, 3, 6, 8))
    attn_ops.masked_attention(qh, kh, kh, torch.zeros(1, 4, 6), 0.5)
    assert attn_ops.launch_counts() == {"window_attention": 0,
                                        "stripe_attention": 0,
                                        "window_attention_bwd": 0,
                                        "stripe_attention_bwd": 0,
                                        "msda_taps": 0,
                                        "masked_attention": 0,
                                        "masked_attention_bwd": 0,
                                        "window_attention_pos_bwd": 0}
