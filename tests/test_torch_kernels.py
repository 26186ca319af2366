"""The port's kernel wrappers (``nmrf_tpu_torch/ops/attention.py``).

On the CPU: input checks, the plain versions against the JAX package's
Pallas stripe kernel (interpret mode) and the stage masks, and that the
wrappers no longer refuse inputs that require grad.  The kernels themselves are tested on the card by
``tests/test_torch_gpu.py``.  Tolerance: float32 atol = rtol = 1e-5
against JAX (same math, another summation order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nmrf_tpu.models.nmp import window_attn_mask
from nmrf_tpu.ops.pallas import attention as pallas_attn
from nmrf_tpu_torch.ops import attention as A


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("H_sp,W_sp", [(6, 1), (1, 10)])
def test_stripe_plain_matches_pallas_kernel(H_sp, W_sp):
    rng = np.random.RandomState(0)
    q, k, v = (_rand(rng, 1, 6, 10, 3, 16) for _ in range(3))
    T = H_sp * W_sp * 3
    mask = jnp.asarray(window_attn_mask((H_sp, W_sp, 3)))
    want = np.asarray(pallas_attn.stripe_attention_direct(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask, 8 ** -0.5,
        H_sp, W_sp, 2, interpret=True))
    got = A.stripe_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             H_sp, W_sp, 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(A.stripe_mask(T, 3) < -1e8,
                                  np.asarray(mask) < -1e8)


def test_window_mask_matches_stage_masks():
    """The coordinate-built masks of the kernel's plain version equal the
    JAX stages' shifted-window and candidate masks."""
    from nmrf_tpu.models.nmp import shift_window_attn_mask

    got = A._window_mask(12, 18, 6, 6, 4, 3, True)
    want = shift_window_attn_mask((12, 18), (6, 6, 4), 3)
    np.testing.assert_array_equal(got < -1e8, want < -1e8)
    got = A._window_mask(12, 18, 6, 6, 4, 0, True)
    np.testing.assert_array_equal(got < -1e8,
                                  np.broadcast_to(window_attn_mask((6, 6, 4)) < -1e8,
                                                  got.shape))


def test_wrappers_check_inputs():
    qkv = torch.zeros(1, 8, 8, 1, 24)
    with pytest.raises(ValueError):   # table of the wrong window size
        A.window_attention(qkv, torch.zeros(9, 24), 0, (4, 4), 2, False)
    with pytest.raises(ValueError):   # image not a multiple of the window
        A.window_attention(torch.zeros(1, 6, 8, 1, 24), torch.zeros(49, 24),
                           0, (4, 4), 2, False)
    with pytest.raises(TypeError):
        A.window_attention(qkv.double(), torch.zeros(49, 24), 0, (4, 4), 2,
                           False)
    q = torch.zeros(1, 4, 6, 2, 8)
    with pytest.raises(ValueError):
        A.stripe_attention(q, q, torch.zeros(1, 4, 6, 2, 4), 4, 1, 2)
    with pytest.raises(ValueError):
        A.stripe_attention(q, q, q, 3, 1, 2)


def test_inference_only_guard():
    """The inference-only guard is gone: the wrappers take inputs that
    require grad and are differentiable (on the CPU through their plain
    versions; the backward wrappers give the same gradients)."""
    assert not hasattr(A, "_check_inference_only")
    rng = np.random.RandomState(1)
    qkv = torch.from_numpy(_rand(rng, 1, 8, 8, 1, 24)).requires_grad_()
    table = torch.from_numpy(_rand(rng, 49, 24)).requires_grad_()
    g = torch.from_numpy(_rand(rng, 1, 8, 8, 1, 8))
    A.window_attention(qkv, table, 2, (4, 4), 2, False).backward(g)
    dqkv, dtable = A.window_attention_bwd(g, qkv.detach(), table.detach(), 2,
                                          (4, 4), 2, False)
    torch.testing.assert_close(qkv.grad, dqkv, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(table.grad, dtable, atol=1e-5, rtol=1e-5)
