"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
module imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; there, skip the JAX-pinning conftest:
``python -m pytest -m gpu --noconftest tests/test_torch_gpu.py``.
Tolerance against the plain version on identical inputs: f32 atol = rtol
= 1e-4 (summation order); bf16 atol 2e-2, rtol 1e-2 (one bf16 rounding of
the output).
"""

import pytest
import torch

from nmrf_tpu_torch.ops import attention as A


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


_GPU_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(48, 156, 4, 6, 3, True), (96, 312, 1, 4, 2, False),
                                  (12, 18, 4, 6, 0, True)])
def test_window_kernel_matches_plain(cuda, dtype, case):
    Hp, Wp, N, ws, shift, cand = case
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(1, Hp, Wp, N, 384, generator=g, device=cuda).to(dtype)
    table = 0.5 * torch.randn((2 * ws - 1) ** 2, 384, generator=g, device=cuda)
    before = A.window_attention.launches
    with torch.inference_mode():
        got = A.window_attention(qkv, table, shift, (ws, ws), 4, cand)
        want = A.window_attention_plain(qkv, table, shift, (ws, ws), 4, cand)
    assert A.window_attention.launches == before + 1
    atol, rtol = _GPU_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H_sp,W_sp", [(47, 1), (1, 156)])
def test_stripe_kernel_matches_plain(cuda, dtype, H_sp, W_sp):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(1, 47, 156, 4, 64, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before = A.stripe_attention.launches
    with torch.inference_mode():
        got = A.stripe_attention(q, k, v, H_sp, W_sp, 2)
        want = A.stripe_attention_plain(q, k, v, H_sp, W_sp, 2)
    assert A.stripe_attention.launches == before + 1
    atol, rtol = _GPU_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
def test_cuda_input_requiring_grad_raises(cuda):
    q = torch.zeros(1, 4, 6, 2, 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        A.stripe_attention(q, q, q, 4, 1, 2)
    qkv = torch.zeros(1, 8, 8, 1, 384, device=cuda)
    table = torch.zeros(49, 384, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        A.window_attention(qkv, table, 0, (4, 4), 4, False)
