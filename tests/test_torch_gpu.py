"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
module imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch; there, skip the JAX-pinning conftest:
``python -m pytest -m gpu --noconftest tests/test_torch_gpu.py``.
Tolerance against the plain version on identical inputs: f32 atol = rtol
= 1e-4 (summation order); bf16 atol 2e-2, rtol 1e-2 (one bf16 rounding of
the output).  The backward kernels are held against autograd through the
plain forward versions; their bf16 d(qkv) is one bf16 rounding of sums of
up to T products of magnitude about 1 and gets atol 5e-2, rtol 2e-2.
K1b and K2b are also held at the training step's batch of 8 (K2b on
ragged stripes too) and against themselves (two launches, the same bits),
K1b also on the sharded step's tiles.
The tap-MSDA kernel (B5) is held against its plain version, the dense tap
sum, at the forward tolerances.  The masked attention B6 and its backward
B6b (at the serving and training shapes, on ragged shapes at every head
dim, and B6b against itself), and K1/K1b on a tile's row offset, are held
at the same tolerances;
the sharded path runs on a 1 x 2 grid with both ranks on the card (gloo)
and, given four cards, on a 2 x 2 grid over NCCL.  The fully fused window
backward B7 (the ``NMRF_FUSED_POS=1`` path) is held against its plain
version at the backward tolerances (its tensor-core kernel also at the
training batch of 8 and on tiles), against K1b in f32, and against itself
(two launches, the same bits).  K2's tensor-core kernel is held at the
serving and training stripes at batch 1 and 8, and on ragged tiny stripes
at every head dim.  K1's tensor-core kernel is held at the serving,
training and tile windows at batch 1 and 8, and the CUDA-core kernel at
shapes outside its set; B5's vector kernel at the four extractor shapes
and its scalar kernel off them.  The tap-MSDA backward B5b is held
against its plain version at the swin training step's four extractor
shapes and off them (backward tolerances), with its tap masks and, past
r 5, walking every cell, against itself (same bits), and through the
autograd function against the plain versions' gradients; B5 and B5b
also at a rank's H tile (row offsets of the queries and the level map).
K1 and K1b launched from two threads of a fresh process give the bits of
a launch alone.  Which kernel ran
(K1's tensor-core or CUDA-core kernel, B5's and B5b's vector or scalar
path, B5b's masks or walk) is read from the count ``ops/_native.py:launch``
keeps of the variant each C entry reports launching.  The serving kernels' registered
operators (``nmrf::window_attention``, ``nmrf::stripe_attention``,
``nmrf::msda_taps``) pass ``torch.library.opcheck`` in f32 and bf16 and
equal the plain versions at the forward tolerances; a small model of each
variant exported on the card holds one operator node per launch, and its
loaded artifact launches the kernels as often and equals the live model
bit for bit.  ``predict`` on the card allocates a pinned staging buffer
only for a new frame shape or dtype, and hands the model the CPU path's
input bit for bit.  RAFT-Stereo's and IGEV-Stereo's update loops replay
their CUDA graphs with the eager loop's bits in every tensor their hooks
see, captured once a shape; so does NMRF's served forward (resnet and swin at 375x1242), which
launches the port's kernels as often as the eager forward.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from nmrf_tpu_torch import (build_criterion, build_model, build_optimizer,
                            get_cfg, make_train_step)
from nmrf_tpu_torch.data import synthetic_batch
from nmrf_tpu_torch.ops import _native
from nmrf_tpu_torch.ops import attention as A
from nmrf_tpu_torch.ops import msda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


_GPU_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
_GPU_BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 2e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(48, 156, 4, 6, 3, True), (96, 312, 1, 4, 2, False),
                                  (12, 18, 4, 6, 0, True)])
def test_window_kernel_matches_plain(cuda, dtype, case):
    Hp, Wp, N, ws, shift, cand = case
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(1, Hp, Wp, N, 384, generator=g, device=cuda).to(dtype)
    table = 0.5 * torch.randn((2 * ws - 1) ** 2, 384, generator=g, device=cuda)
    before = _native.launch_counts()["window_attention"]
    with torch.inference_mode():
        got = A.window_attention(qkv, table, shift, (ws, ws), 4, cand)
        want = A.window_attention_plain(qkv, table, shift, (ws, ws), 4, cand)
    assert _native.launch_counts()["window_attention"] == before + 1
    atol, rtol = _GPU_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H_sp,W_sp", [(47, 1), (1, 156)])
def test_stripe_kernel_matches_plain(cuda, dtype, H_sp, W_sp):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(1, 47, 156, 4, 64, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before = _native.launch_counts()["stripe_attention"]
    with torch.inference_mode():
        got = A.stripe_attention(q, k, v, H_sp, W_sp, 2)
        want = A.stripe_attention_plain(q, k, v, H_sp, W_sp, 2)
    assert _native.launch_counts()["stripe_attention"] == before + 1
    atol, rtol = _GPU_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


# training shapes (384x768 crop, 1/8 and 1/4 grids) and KITTI shapes
_WINDOW_BWD_CASES = [(48, 96, 4, 6, 0, True), (48, 96, 4, 6, 3, True),
                     (96, 192, 1, 4, 0, False), (96, 192, 1, 4, 2, False),
                     (48, 156, 4, 6, 3, True), (96, 312, 1, 4, 2, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _WINDOW_BWD_CASES)
def test_window_bwd_kernel_matches_autograd_of_plain(cuda, dtype, case):
    Hp, Wp, N, ws, shift, cand = case
    g = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(1, Hp, Wp, N, 384, generator=g, device=cuda).to(dtype)
    table = 0.5 * torch.randn((2 * ws - 1) ** 2, 384, generator=g, device=cuda)
    gout = torch.randn(1, Hp, Wp, N, 128, generator=g, device=cuda).to(dtype)
    qkv.requires_grad_()
    table.requires_grad_()
    before = _native.launch_counts()["window_attention_bwd"]
    got = A.window_attention_bwd(gout, qkv.detach(), table.detach(), shift,
                                 (ws, ws), 4, cand)
    assert _native.launch_counts()["window_attention_bwd"] == before + 1
    out = A.window_attention_plain(qkv, table, shift, (ws, ws), 4, cand)
    want = torch.autograd.grad(out, (qkv, table), gout)
    atol, rtol = _GPU_BWD_TOL[dtype]
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol,
                               rtol=rtol)
    # d(table) is f32 on both sides; autograd's passes a bf16 rounding
    torch.testing.assert_close(got[1], want[1].float(), atol=atol * 10,
                               rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(48, 96, 48, 1), (48, 96, 1, 96),
                                   (47, 156, 47, 1), (47, 156, 1, 156)])
def test_stripe_bwd_kernel_matches_autograd_of_plain(cuda, dtype, shape):
    H, W, H_sp, W_sp = shape
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, gout = (torch.randn(1, H, W, 4, 64, generator=g, device=cuda)
                     .to(dtype) for _ in range(4))
    before = _native.launch_counts()["stripe_attention_bwd"]
    got = A.stripe_attention_bwd(gout, q, k, v, H_sp, W_sp, 2)
    assert _native.launch_counts()["stripe_attention_bwd"] == before + 1
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = A.stripe_attention_plain(*qkv, H_sp, W_sp, 2)
    want = torch.autograd.grad(out, qkv, gout)
    atol, rtol = _GPU_BWD_TOL[dtype]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("shape", [(47, 156, 47, 1), (47, 156, 1, 156)],
                         ids=["T188", "T624"])
def test_stripe_bwd_kernel_batch8_ragged_and_repeatable(cuda, dtype, hd, shape):
    """K2b at batch 8 on the KITTI stripes (T 188, not a multiple of the
    16-row tiles, and T 624) and every supported head dim, against its plain
    version; two launches on the same inputs give the same bits."""
    H, W, H_sp, W_sp = shape
    g = torch.Generator(device=cuda).manual_seed(11)
    args = tuple(torch.randn(8, H, W, 4, 64, generator=g, device=cuda).to(dtype)
                 for _ in range(4)) + (H_sp, W_sp, 64 // hd)
    got = A.stripe_attention_bwd(*args)
    atol, rtol = _GPU_BWD_TOL[dtype]
    for a, b in zip(got, A.stripe_attention_bwd_plain(*args)):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)
    for a, b in zip(got, A.stripe_attention_bwd(*args)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _WINDOW_BWD_CASES[:4],
                         ids=["inference-shift0", "inference-shift3",
                              "refinement-shift0", "refinement-shift2"])
def test_window_bwd_kernel_batch8_and_repeatable(cuda, dtype, case):
    """K1b at the training step's shapes and batch (8) against its plain
    version; two launches on the same inputs give the same bits (d(ve) is
    summed from fixed-order partials and the table scatter is a gather and
    a sum: no atomics)."""
    Hp, Wp, N, ws, shift, cand = case
    g = torch.Generator(device=cuda).manual_seed(12)
    qkv = torch.randn(8, Hp, Wp, N, 384, generator=g, device=cuda).to(dtype)
    table = 0.5 * torch.randn((2 * ws - 1) ** 2, 384, generator=g, device=cuda)
    gout = torch.randn(8, Hp, Wp, N, 128, generator=g, device=cuda).to(dtype)
    args = (gout, qkv, table, shift, (ws, ws), 4, cand)
    got = A.window_attention_bwd(*args)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    atol, rtol = _GPU_BWD_TOL[dtype]
    want = A.window_attention_bwd_plain(*args)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol,
                               rtol=rtol)
    # d(table) sums over every window of the batch (18,432 at Refinement),
    # in another order than the plain version's: atol as in
    # test_window_bwd_kernel_matches_autograd_of_plain
    torch.testing.assert_close(got[1], want[1], atol=atol * 10, rtol=rtol)
    for a, b in zip(got, A.window_attention_bwd(*args)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_input_requiring_grad_goes_through_the_kernels(cuda):
    """A CUDA input that requires grad runs the forward and backward kernels
    (once each) and gets the plain versions' gradients."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(1, 4, 6, 2, 64, generator=g, device=cuda, requires_grad=True)
    counts = _native.launch_counts()
    A.stripe_attention(q, q, q, 4, 1, 2).square().sum().backward()
    qkv = torch.randn(1, 8, 8, 1, 384, generator=g, device=cuda,
                      requires_grad=True)
    table = torch.randn(49, 384, generator=g, device=cuda, requires_grad=True)
    A.window_attention(qkv, table, 0, (4, 4), 4, False).square().sum().backward()
    after = _native.launch_counts()
    assert {k: after[k] - counts[k] for k in after} == dict(
        dict.fromkeys(after, 1), msda_taps=0, masked_attention=0,
        masked_attention_bwd=0, window_attention_pos_bwd=0, msda_taps_bwd=0)
    q2 = q.detach().clone().requires_grad_()
    A.stripe_attention_plain(q2, q2, q2, 4, 1, 2).square().sum().backward()
    torch.testing.assert_close(q.grad, q2.grad, atol=1e-4, rtol=1e-4)
    qkv2 = qkv.detach().clone().requires_grad_()
    table2 = table.detach().clone().requires_grad_()
    A.window_attention_plain(qkv2, table2, 0, (4, 4), 4, False).square().sum() \
        .backward()
    torch.testing.assert_close(qkv.grad, qkv2.grad, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(table.grad, table2.grad, atol=1e-3, rtol=1e-4)


@pytest.mark.gpu
def test_train_steps_through_kernels_match_plain(cuda):
    """Two training steps of a 2-layer model on a 64x128 batch of 2, f32:
    through the kernels (4 launches of each of the four per step: 2 + 2
    window layers, 2 x 2 stripe halves, forward and backward) and on the
    plain versions, from the same weights, give the same losses."""
    cfg = get_cfg()
    cfg.NMP.NUM_PROP_LAYERS = cfg.NMP.NUM_INFER_LAYERS = 2
    cfg.NMP.NUM_REFINE_LAYERS = 2
    cfg.SOLVER.LOSS_WEIGHTS = [1.0, 1.2, 1.4, 2.0]
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in synthetic_batch(2, 64, 128, 48, seed=0).items()}
    losses = {}
    for use_kernels in (True, False):
        cfg.TPU.USE_PALLAS = use_kernels
        model = build_model(cfg, device=cuda)
        optimizer, scheduler = build_optimizer(model, cfg)
        step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                               grad_clip=cfg.SOLVER.GRAD_CLIP)
        _native.reset_launch_counts()
        losses[use_kernels] = [step(batch) for _ in range(2)]
        want = 2 * 4 if use_kernels else 0
        assert _native.launch_counts() == dict(dict.fromkeys(_native.launch_counts(), want),
                                         msda_taps=0, masked_attention=0,
                                         masked_attention_bwd=0,
                                         window_attention_pos_bwd=0,
                                         msda_taps_bwd=0)
    for got, ref in zip(losses[True], losses[False]):
        for key, value in ref.items():
            assert torch.isfinite(got[key])
            np.testing.assert_allclose(got[key].item(), value.item(),
                                       rtol=1e-3, atol=1e-4, err_msg=key)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 8])
@pytest.mark.parametrize("spread", [4.0, 8.0], ids=["within_r", "beyond_r"])
def test_msda_taps_kernel_matches_plain(cuda, dtype, f, spread):
    """B5 at the swin neck's widths (M 8, D 8, P 4, r 5, batch 2) at level
    factors 1 and 8; displacements up to ``spread`` level pixels, so the
    second case has samples beyond the radius (dropped) and, at the
    borders, outside the level map (zeros)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    Hq, Wq = 48, 64
    vmap = torch.randn(2, Hq // f, Wq // f, 64, generator=g, device=cuda).to(dtype)
    dx, dy = ((torch.rand(2, Hq, Wq, 32, generator=g, device=cuda) * 2 - 1)
              * spread for _ in range(2))
    aw = torch.rand(2, Hq, Wq, 32, generator=g, device=cuda)
    before = _native.launch_counts()["msda_taps"]
    with torch.inference_mode():
        got = msda.msda_taps(vmap, dx, dy, aw, 8, 5)
        want = msda.msda_taps_plain(vmap, dx, dy, aw, 8, 5)
    assert _native.launch_counts()["msda_taps"] == before + 1
    atol, rtol = _GPU_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
def test_swin_forward_through_kernels_matches_plain(cuda):
    """The swin variant (2 layers per NMP stage, 64 x 128, f32) through the
    kernels (4 B5 launches, one per extractor, and 4 of K1 and K2) and on
    the plain versions, from the same weights."""
    cfg = get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parent.parent / "configs"
                            / "sceneflow_swint.yaml"))
    cfg.NMP.NUM_PROP_LAYERS = cfg.NMP.NUM_INFER_LAYERS = 2
    cfg.NMP.NUM_REFINE_LAYERS = 2
    rng = np.random.RandomState(0)
    imgs = [torch.from_numpy((rng.rand(1, 64, 128, 3) * 255).astype(np.float32))
            .to(cuda) for _ in range(2)]
    outs = {}
    for use_kernels in (True, False):
        cfg.TPU.USE_PALLAS = use_kernels
        model = build_model(cfg, device=cuda)
        _native.reset_launch_counts()
        with torch.inference_mode():
            outs[use_kernels] = model(*imgs)
        want = 4 if use_kernels else 0
        assert _native.launch_counts() == {"window_attention": want,
                                     "stripe_attention": want,
                                     "window_attention_bwd": 0,
                                     "stripe_attention_bwd": 0,
                                     "msda_taps": want,
                                     "masked_attention": 0,
                                     "masked_attention_bwd": 0,
                                     "window_attention_pos_bwd": 0,
                                     "msda_taps_bwd": 0}
    for key in ("prob", "proposal", "initial_proposal"):
        torch.testing.assert_close(outs[True][key], outs[False][key],
                                   atol=2e-4, rtol=1e-3)


# ---- the H-sharded path: B6, B6b, K1/K1b at a tile's row offset ---- #

def _stripe_tile_mask(tile, device):
    """Tile `tile`'s rows of the global anti-same-pixel mask of a 48-row
    vertical stripe split over 2 tiles (Rq 96, Rk 192), as [1, Rq, Rk]."""
    return torch.as_tensor(A.stripe_mask(192, 4)[tile * 96:(tile + 1) * 96],
                           device=device)[None]


def _check_masked_kernels(q, k, v, mask, gout, scale):
    """B6 against its plain version and B6b against autograd through it,
    one launch each."""
    before = _native.launch_counts()
    with torch.inference_mode():
        got = A.masked_attention(q, k, v, mask, scale)
        want = A.masked_attention_plain(q, k, v, mask, scale)
    dgot = A.masked_attention_bwd(gout, q, k, v, mask, scale)
    after = _native.launch_counts()
    assert after["masked_attention"] == before["masked_attention"] + 1
    assert after["masked_attention_bwd"] == before["masked_attention_bwd"] + 1
    atol, rtol = _GPU_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    dwant = torch.autograd.grad(A.masked_attention_plain(*qkv, mask, scale),
                                qkv, gout)
    atol, rtol = _GPU_BWD_TOL[q.dtype]
    for a, b in zip(dgot, dwant):
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_kind", ["tile0", "tile1", "per-group"])
@pytest.mark.parametrize("G", [156, 768])
def test_masked_kernels_match_plain(cuda, dtype, mask_kind, G):
    """B6 against its plain version and B6b against autograd through it, at
    the sharded path's shape (2 heads of 32, Rq 96, Rk 192; G 156 serving,
    768 training; bf16: the tensor-core kernels, Gm 1 and Gm = G)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, gout = (torch.randn(2, G, 96, 32, generator=g, device=cuda).to(dtype)
               for _ in range(2))
    k, v = (torch.randn(2, G, 192, 32, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    if mask_kind == "per-group":
        mask = torch.randn(G, 96, 192, generator=g, device=cuda)
    else:
        mask = _stripe_tile_mask(int(mask_kind[-1]), cuda)
    _check_masked_kernels(q, k, v, mask, gout, 32 ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("shape", [(40, 72, "per-group"), (136, 40, "one"),
                                   (20, 130, "one"), (128, 400, "one"),
                                   (800, 100, "one")],
                         ids=["ragged", "two-row-tiles", "ragged-keys",
                              "mask-rows-in-memory", "strip-in-memory"])
def test_masked_kernels_ragged_shapes_and_head_dims(cuda, dtype, hd, shape):
    """B6 and B6b on ragged row and key tiles at every head dim (bf16: the
    tensor-core kernels), with random masks holding -1e9 entries and one
    query row masked everywhere (the plain version's uniform softmax);
    Rq 136 takes two query-row tiles, and at (128, 400) and (800, 100) the
    staged mask rows or the key side's strip do not fit in shared memory,
    so the kernels read the mask from device memory."""
    Rq, Rk, kind = shape
    g = torch.Generator(device=cuda).manual_seed(11)
    h, G = 2, 3
    q, gout = (torch.randn(h, G, Rq, hd, generator=g, device=cuda).to(dtype)
               for _ in range(2))
    k, v = (torch.randn(h, G, Rk, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    Gm = G if kind == "per-group" else 1
    mask = torch.where(torch.rand(Gm, Rq, Rk, generator=g, device=cuda) < 0.3,
                       -1e9, torch.randn(Gm, Rq, Rk, generator=g, device=cuda))
    mask[:, 1] = -1e9
    _check_masked_kernels(q, k, v, mask, gout, hd ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [156, 768])
def test_masked_bwd_kernel_is_deterministic(cuda, G):
    """Two B6b launches on the same bf16 inputs (the sharded path's shapes,
    tile-1 mask) give the same bits: every row has one owner."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q, gout = (torch.randn(2, G, 96, 32, generator=g, device=cuda,
                           dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(2, G, 192, 32, generator=g, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    mask = _stripe_tile_mask(1, cuda)
    first = A.masked_attention_bwd(gout, q, k, v, mask, 32 ** -0.5)
    second = A.masked_attention_bwd(gout, q, k, v, mask, 32 ** -0.5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(24, 96, 4, 6, 3, True, 24, 48),
                                  (24, 96, 4, 6, 3, True, 0, 48),
                                  (48, 192, 1, 4, 2, False, 48, 96)])
def test_window_kernels_at_a_tile_match_plain(cuda, dtype, case):
    """K1 and K1b on an H tile (rows row0.. of an image of hp_total rows:
    the shifted-region mask in global rows) against their plain versions;
    a second K1b launch gives the same bits."""
    Hp, Wp, N, ws, shift, cand, row0, hp_total = case
    g = torch.Generator(device=cuda).manual_seed(8)
    qkv = torch.randn(2, Hp, Wp, N, 384, generator=g, device=cuda).to(dtype)
    table = 0.5 * torch.randn((2 * ws - 1) ** 2, 384, generator=g, device=cuda)
    gout = torch.randn(2, Hp, Wp, N, 128, generator=g, device=cuda).to(dtype)
    args = (qkv, table, shift, (ws, ws), 4, cand, row0, hp_total)
    with torch.inference_mode():
        got = A.window_attention(*args)
        want = A.window_attention_plain(*args)
    atol, rtol = _GPU_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    dgot = A.window_attention_bwd(gout, *args)
    dwant = A.window_attention_bwd_plain(gout, *args)
    atol, rtol = _GPU_BWD_TOL[dtype]
    for a, b in zip(dgot, dwant):
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)
    for a, b in zip(dgot, A.window_attention_bwd(gout, *args)):
        assert torch.equal(a, b)


# ---- B7: the fully fused window backward (NMRF_FUSED_POS=1) ---- #

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [c + (0, None) for c in _WINDOW_BWD_CASES]
                         + [(24, 96, 4, 6, 3, True, 24, 48),
                            (48, 192, 1, 4, 2, False, 48, 96)])
def test_window_pos_bwd_kernel_matches_plain(cuda, dtype, case):
    """B7 against its plain version at the training, KITTI and tile shapes,
    and in f32 against K1b (the same function)."""
    Hp, Wp, N, ws, shift, cand, row0, hp_total = case
    g = torch.Generator(device=cuda).manual_seed(9)
    qkv = torch.randn(2, Hp, Wp, N, 384, generator=g, device=cuda).to(dtype)
    table = 0.5 * torch.randn((2 * ws - 1) ** 2, 384, generator=g, device=cuda)
    gout = torch.randn(2, Hp, Wp, N, 128, generator=g, device=cuda).to(dtype)
    args = (gout, qkv, table, shift, (ws, ws), 4, cand, row0, hp_total)
    before = _native.launch_counts()["window_attention_pos_bwd"]
    got = A.window_attention_pos_bwd(*args)
    assert _native.launch_counts()["window_attention_pos_bwd"] == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    atol, rtol = _GPU_BWD_TOL[dtype]
    for a, b in zip(got, A.window_attention_pos_bwd_plain(*args)):
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)
    if dtype == torch.float32:
        for a, b in zip(got, A.window_attention_bwd(*args)):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(48, 96, 4, 6, 3, True), (96, 192, 1, 4, 2, False)])
def test_window_pos_bwd_kernel_is_deterministic(cuda, case):
    """Two B7 launches on the same batch-8 bf16 inputs give the same bits
    (the table cotangent is summed without atomics, in a fixed order)."""
    Hp, Wp, N, ws, shift, cand = case
    g = torch.Generator(device=cuda).manual_seed(10)
    qkv = torch.randn(8, Hp, Wp, N, 384, generator=g, device=cuda,
                      dtype=torch.bfloat16)
    table = 0.5 * torch.randn((2 * ws - 1) ** 2, 384, generator=g, device=cuda)
    gout = torch.randn(8, Hp, Wp, N, 128, generator=g, device=cuda,
                       dtype=torch.bfloat16)
    args = (gout, qkv, table, shift, (ws, ws), 4, cand)
    first = A.window_attention_pos_bwd(*args)
    second = A.window_attention_pos_bwd(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c + (0, None) for c in _WINDOW_BWD_CASES[:4]]
                         + [(24, 96, 4, 6, 3, True, 24, 48),
                            (48, 192, 1, 4, 2, False, 48, 96)],
                         ids=["inference-shift0", "inference-shift3",
                              "refinement-shift0", "refinement-shift2",
                              "inference-tile1", "refinement-tile1"])
def test_window_pos_bwd_mma_kernel_batch8_matches_plain(cuda, case):
    """B7's tensor-core kernel (bf16, T 144 and 16) at the training batch
    of 8, on whole images and on a sharded rank's tile, against its plain
    version: d(qkv) and d(table), the latter summed over every window of
    the batch (its W products take bf16 hi + lo parts)."""
    Hp, Wp, N, ws, shift, cand, row0, hp_total = case
    g = torch.Generator(device=cuda).manual_seed(15)
    qkv = torch.randn(8, Hp, Wp, N, 384, generator=g, device=cuda,
                      dtype=torch.bfloat16)
    table = 0.5 * torch.randn((2 * ws - 1) ** 2, 384, generator=g, device=cuda)
    gout = torch.randn(8, Hp, Wp, N, 128, generator=g, device=cuda,
                       dtype=torch.bfloat16)
    args = (gout, qkv, table, shift, (ws, ws), 4, cand, row0, hp_total)
    before = _native.launch_counts()["window_attention_pos_bwd"]
    got = A.window_attention_pos_bwd(*args)
    assert _native.launch_counts()["window_attention_pos_bwd"] == before + 1
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    atol, rtol = _GPU_BWD_TOL[torch.bfloat16]
    for a, b in zip(got, A.window_attention_pos_bwd_plain(*args)):
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("shape", [(47, 156, 47, 1), (47, 156, 1, 156),
                                   (48, 96, 48, 1), (48, 96, 1, 96)],
                         ids=["T188", "T624", "T192", "T384"])
def test_stripe_kernel_bf16_serving_and_training_shapes(cuda, batch, shape):
    """K2's tensor-core kernel at the serving (T 188, 624) and training
    (T 192, 384) stripes, batch 1 and 8, against its plain version."""
    H, W, H_sp, W_sp = shape
    g = torch.Generator(device=cuda).manual_seed(16)
    q, k, v = (torch.randn(batch, H, W, 4, 64, generator=g, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    before = _native.launch_counts()["stripe_attention"]
    with torch.inference_mode():
        got = A.stripe_attention(q, k, v, H_sp, W_sp, 2)
        want = A.stripe_attention_plain(q, k, v, H_sp, W_sp, 2)
    assert _native.launch_counts()["stripe_attention"] == before + 1
    atol, rtol = _GPU_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("shape", [(5, 6, 5, 1, 4), (3, 22, 1, 11, 2),
                                   (2, 40, 1, 20, 4)],
                         ids=["T20", "T22", "T80"])
def test_stripe_kernel_ragged_stripes_and_head_dims(cuda, dtype, hd, shape):
    """K2 on tiny stripes that fill no 16-row tile (T 20, 22) or end
    inside one (T 80 = 64 + 16), with 1, 2 or 4 candidates, at every
    supported head dim, against its plain version."""
    H, W, H_sp, W_sp, N = shape
    g = torch.Generator(device=cuda).manual_seed(17)
    q, k, v = (torch.randn(2, H, W, N, 64, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    with torch.inference_mode():
        got = A.stripe_attention(q, k, v, H_sp, W_sp, 64 // hd)
        want = A.stripe_attention_plain(q, k, v, H_sp, W_sp, 64 // hd)
    atol, rtol = _GPU_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("setting", ["inference", "refinement"])
def test_window_attention_grads_through_b7(cuda, monkeypatch, setting):
    """WindowAttention with NMRF_FUSED_POS=1, f32: one K1 and one B7 launch
    (no K1b), and the gradients of the plain module's autograd."""
    from nmrf_tpu_torch.models import nmp

    ws, N, cand = (6, 4, True) if setting == "inference" else (4, 1, False)
    monkeypatch.setenv("NMRF_FUSED_POS", "1")
    g = torch.Generator(device=cuda).manual_seed(11)
    qkv = torch.randn(2, 4 * ws, 6 * ws, N, 384, generator=g, device=cuda)
    R = torch.randn(2, 4 * ws, 6 * ws, N, 128, generator=g, device=cuda)
    table = torch.randn((2 * ws - 1) ** 2, 384, generator=g, device=cuda)
    grads = {}
    for use_kernels in (True, False):
        module = nmp.WindowAttention(128, (ws, ws), 4, cand,
                                     use_kernels=use_kernels).to(cuda)
        with torch.no_grad():
            module.relative_position_enc_table.copy_(table)
        x = qkv.clone().requires_grad_()
        _native.reset_launch_counts()
        (module(x, ws // 2) * R).sum().backward()
        grads[use_kernels] = (x.grad, module.relative_position_enc_table.grad)
        counts = _native.launch_counts()
        assert counts == dict(dict.fromkeys(counts, 0), **(
            {"window_attention": 1, "window_attention_pos_bwd": 1}
            if use_kernels else {}))
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ---- K1's tensor-core kernel and B5's vector kernel ---- #

def _ran(kernel, fn):
    """fn()'s result and the variants of ``kernel`` it launched:
    {variant: launches}, from the count ``_native.launch`` keeps of the
    variant its C entry reports (``_native.variant_counts``)."""
    before = _native.variant_counts()[kernel]
    out = fn()
    after = _native.variant_counts()[kernel]
    return out, {k: n - before.get(k, 0) for k, n in after.items()
                 if n != before.get(k, 0)}


# (Hp, Wp, N, ws, shift, candidate_mask, row0, hp_total): the KITTI serving
# windows, the training windows, and a sharded rank's tiles
_K1_MMA_CASES = {
    "kitti-inference-shift0": (48, 156, 4, 6, 0, True, 0, None),
    "kitti-inference-shift3": (48, 156, 4, 6, 3, True, 0, None),
    "kitti-refinement-shift0": (96, 312, 1, 4, 0, False, 0, None),
    "kitti-refinement-shift2": (96, 312, 1, 4, 2, False, 0, None),
    "train-inference-shift0": (48, 96, 4, 6, 0, True, 0, None),
    "train-inference-shift3": (48, 96, 4, 6, 3, True, 0, None),
    "train-refinement-shift0": (96, 192, 1, 4, 0, False, 0, None),
    "train-refinement-shift2": (96, 192, 1, 4, 2, False, 0, None),
    "inference-tile1": (24, 96, 4, 6, 3, True, 24, 48),
    "refinement-tile1": (48, 192, 1, 4, 2, False, 48, 96),
}


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("case", list(_K1_MMA_CASES))
def test_window_mma_kernel_matches_plain(cuda, case, batch):
    """K1 in bf16 at the serving, training and tile windows (T 144 and 16)
    runs its tensor-core kernel, once per call, and matches its plain
    version."""
    Hp, Wp, N, ws, shift, cand, row0, hp_total = _K1_MMA_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(18)
    qkv = torch.randn(batch, Hp, Wp, N, 384, generator=g, device=cuda,
                      dtype=torch.bfloat16)
    table = 0.5 * torch.randn((2 * ws - 1) ** 2, 384, generator=g, device=cuda)
    args = (qkv, table, shift, (ws, ws), 4, cand, row0, hp_total)
    before = _native.launch_counts()["window_attention"]
    with torch.inference_mode():
        got, ran = _ran("window_attention", lambda: A.window_attention(*args))
        want = A.window_attention_plain(*args)
    assert _native.launch_counts()["window_attention"] == before + 1
    assert ran == {"mma": 1}, ran
    atol, rtol = _GPU_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(12, 36, 2, 6, 3, True), (8, 12, 3, 4, 2, False),
                                  (12, 12, 4, 6, 3, True)],
                         ids=["N2-T72", "N3-T48", "T144"])
def test_window_kernel_outside_the_mma_set(cuda, dtype, case):
    """K1 on the CUDA-core kernel: f32 at any window, and bf16 where T is
    not 16 or 144 or N not a power of two up to 8; the bf16 T 144 case
    takes the tensor-core kernel.  Each matches its plain version."""
    Hp, Wp, N, ws, shift, cand = case
    g = torch.Generator(device=cuda).manual_seed(19)
    qkv = torch.randn(2, Hp, Wp, N, 384, generator=g, device=cuda).to(dtype)
    table = 0.5 * torch.randn((2 * ws - 1) ** 2, 384, generator=g, device=cuda)
    args = (qkv, table, shift, (ws, ws), 4, cand)
    with torch.inference_mode():
        got, ran = _ran("window_attention", lambda: A.window_attention(*args))
        want = A.window_attention_plain(*args)
    mma = dtype == torch.bfloat16 and ws * ws * N == 144
    assert ran == {"mma" if mma else "cuda_core": 1}, ran
    atol, rtol = _GPU_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


# K1 and K1b from two threads of a fresh process, no kernel yet set up:
# (Hp, Wp, N, ws, shift, candidate_mask), Refinement first, so that the f32
# CUDA-core kernels' shared-memory attribute (one per kernel instantiation,
# both windows) grows at each thread's first Inference launch
_TWO_THREAD_WINDOWS = [(96, 192, 1, 4, 2, False), (48, 96, 4, 6, 3, True)]
_TWO_THREAD_ROUNDS = 16


def _two_thread_jobs():
    """[(wrapper name, args)]: K1 and K1b at each window in f32 and bf16,
    the inputs drawn on the CPU from a seed, so two processes hold the
    same."""
    g = torch.Generator().manual_seed(23)
    jobs = []
    for dtype in (torch.float32, torch.bfloat16):
        for Hp, Wp, N, ws, shift, cand in _TWO_THREAD_WINDOWS:
            qkv = torch.randn(1, Hp, Wp, N, 384, generator=g).to("cuda", dtype)
            table = (0.5 * torch.randn((2 * ws - 1) ** 2, 384, generator=g)).cuda()
            gout = torch.randn(1, Hp, Wp, N, 128, generator=g).to("cuda", dtype)
            args = (qkv, table, shift, (ws, ws), 4, cand)
            jobs += [("window_attention", args), ("window_attention_bwd", (gout,) + args)]
    return jobs


def _run_job(wrapper, args):
    with torch.inference_mode():
        out = getattr(A, wrapper)(*args)
    return out if isinstance(out, tuple) else (out,)


def _two_thread_worker(rank, want_path):
    """Two threads, each on its own stream, launch the jobs in turn (one a
    job ahead of the other) and hold every output to ``want_path``'s."""
    import sys
    import threading

    jobs, want = _two_thread_jobs(), torch.load(want_path)
    torch.cuda.synchronize()
    _native.reset_launch_counts()
    bad, errors = [], []

    def run(offset):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for i in range(_TWO_THREAD_ROUNDS):
                    j = (i + offset) % len(jobs)
                    got = _run_job(*jobs[j])
                    if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want[j])):
                        bad.append(j)
        except Exception as e:  # reported below, from the main thread
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and bad == [], (errors, bad)
    counts = _native.launch_counts()
    assert counts["window_attention"] == counts["window_attention_bwd"] == _TWO_THREAD_ROUNDS


@pytest.mark.gpu
def test_window_kernels_from_two_threads_match_a_launch_alone(cuda, tmp_path):
    """K1 and K1b launched alternately at the Refinement and Inference
    windows, f32 and bf16, from two threads of a fresh process, where the
    launch set-up of ``csrc/common.cuh`` runs for the first time behind its
    lock (the f32 kernels' shared-memory attribute growing between the
    windows), give the bits of a launch alone, and every launch is
    counted."""
    want = [tuple(t.cpu() for t in _run_job(*job)) for job in _two_thread_jobs()]
    torch.save(want, tmp_path / "want.pt")
    torch.multiprocessing.spawn(_two_thread_worker, args=(str(tmp_path / "want.pt"),),
                                nprocs=1, join=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
def test_msda_vector_kernel_at_the_extractor_shapes(cuda, dtype, f):
    """B5 at the swin neck's four extractors (query grid 96 x 312, batch 2,
    M 8, P 4, D 8, r 5) runs its vector kernel, once per call, and matches
    its plain version, with samples up to r + 3 level pixels away: beyond
    the radius (dropped) and past the level map's borders (zeros)."""
    g = torch.Generator(device=cuda).manual_seed(20)
    Hq, Wq = 96, 312
    vmap = torch.randn(2, Hq // f, Wq // f, 64, generator=g, device=cuda).to(dtype)
    dx, dy = ((torch.rand(2, Hq, Wq, 32, generator=g, device=cuda) * 2 - 1) * 8.0
              for _ in range(2))
    aw = torch.rand(2, Hq, Wq, 32, generator=g, device=cuda)
    assert bool(((dx.abs() > 5) | (dy.abs() > 5)).any())
    before = _native.launch_counts()["msda_taps"]
    with torch.inference_mode():
        got, ran = _ran("msda_taps", lambda: msda.msda_taps(vmap, dx, dy, aw, 8, 5))
        want = msda.msda_taps_plain(vmap, dx, dy, aw, 8, 5)
    assert _native.launch_counts()["msda_taps"] == before + 1
    assert ran == {"vector": 1}, ran
    atol, rtol = _GPU_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 4, 6), (8, 3, 8)], ids=["D6", "P3"])
def test_msda_scalar_kernel_off_the_vector_shapes(cuda, dtype, shape):
    """B5 where a head's channels are no whole 16-byte vectors (D 6) or P
    is not a multiple of 4 runs the scalar kernel and matches its plain
    version (samples beyond r and past the borders)."""
    M, P, D = shape
    g = torch.Generator(device=cuda).manual_seed(21)
    Hq, Wq, f = 24, 40, 2
    vmap = torch.randn(2, Hq // f, Wq // f, M * D, generator=g, device=cuda).to(dtype)
    dx, dy = ((torch.rand(2, Hq, Wq, M * P, generator=g, device=cuda) * 2 - 1) * 7.0
              for _ in range(2))
    aw = torch.rand(2, Hq, Wq, M * P, generator=g, device=cuda)
    with torch.inference_mode():
        got, ran = _ran("msda_taps", lambda: msda.msda_taps(vmap, dx, dy, aw, M, 4))
        want = msda.msda_taps_plain(vmap, dx, dy, aw, M, 4)
    assert ran == {"scalar": 1}, ran
    atol, rtol = _GPU_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


# ---- B5b, the tap-MSDA backward ---- #

def _msda_bwd_case(cuda, seed, B, Hq, Wq, f, M, P, D, spread, dtype):
    g = torch.Generator(device=cuda).manual_seed(seed)
    vmap = torch.randn(B, Hq // f, Wq // f, M * D, generator=g, device=cuda).to(dtype)
    dx, dy = ((torch.rand(B, Hq, Wq, M * P, generator=g, device=cuda) * 2 - 1)
              * spread for _ in range(2))
    aw = torch.rand(B, Hq, Wq, M * P, generator=g, device=cuda)
    gout = torch.randn(B, Hq, Wq, M * D, generator=g, device=cuda).to(dtype)
    return vmap, dx, dy, aw, gout


def _check_msda_bwd(got, want, dtype):
    atol, rtol = _GPU_BWD_TOL[dtype]
    for name, a, b in zip(("dv", "ddx", "ddy", "daw"), got, want):
        assert a.dtype == b.dtype, name
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 2, 4, 8])
@pytest.mark.parametrize("spread", [4.0, 8.0], ids=["within_r", "beyond_r"])
def test_msda_bwd_kernel_at_the_training_shapes(cuda, dtype, f, spread):
    """B5b at the swin training step's four extractors (batch 16: the left
    and right images of 8 pairs; query grid 96 x 192, M 8, P 4, D 8, r 5)
    runs its vector path with the tap masks (sample, cell-mask at f > 1 and
    gather kernels), counts one launch a call, matches its plain version at
    the backward tolerances, with samples up to ``spread`` level pixels
    away (beyond the radius and past the borders in the second case), and
    gives the same bits on a second launch."""
    args = _msda_bwd_case(cuda, 30 + f, 16, 96, 192, f, 8, 4, 8, spread, dtype)
    before = _native.launch_counts()["msda_taps_bwd"]
    got, ran = _ran("msda_taps_bwd", lambda: msda.msda_taps_bwd(*args, 8, 5))
    assert _native.launch_counts()["msda_taps_bwd"] == before + 1
    assert ran == {"vector_masks": 1}, ran
    _check_msda_bwd(got, msda.msda_taps_bwd_plain(*args, 8, 5), dtype)
    for a, b in zip(got, msda.msda_taps_bwd(*args, 8, 5)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 2])
@pytest.mark.parametrize("seed", [61, 62, 63, 64, 65])
def test_msda_bwd_kernel_more_seeds_near_the_borders(cuda, f, seed):
    """B5b's gather at f 1 and 2 (f32, the training shapes, samples beyond
    r and past the borders) on more seeds: at f 1 an earlier walk over each
    tap row's columns kept a cell off the map at pixels within r of the
    left border on the card alone (``nmrf_tpu_torch/tools/walk_probe.py``);
    each seed puts a different set of bits on that edge."""
    args = _msda_bwd_case(cuda, seed, 16, 96, 192, f, 8, 4, 8, 8.0, torch.float32)
    got, ran = _ran("msda_taps_bwd", lambda: msda.msda_taps_bwd(*args, 8, 5))
    assert ran == {"vector_masks": 1}, ran
    _check_msda_bwd(got, msda.msda_taps_bwd_plain(*args, 8, 5), torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 8])
def test_msda_bwd_kernel_past_the_mask_radius(cuda, dtype, f):
    """B5b at r 6, whose 169 taps exceed the masks' 128 bits, walks every
    base cell (the vector path's walk kernel) at the training shapes, and
    matches its plain version and itself."""
    args = _msda_bwd_case(cuda, 50 + f, 16, 96, 192, f, 8, 4, 8, 8.0, dtype)
    got, ran = _ran("msda_taps_bwd", lambda: msda.msda_taps_bwd(*args, 8, 6))
    assert ran == {"vector_walk": 1}, ran
    _check_msda_bwd(got, msda.msda_taps_bwd_plain(*args, 8, 6), dtype)
    for a, b in zip(got, msda.msda_taps_bwd(*args, 8, 6)):
        assert torch.equal(a, b)


# a rank's H tile of the sharded swin step's query grid (96 x 192): (f, q0,
# query rows, v0, map rows, level rows); the tiled levels carry radius + 1
# halo rows each side, zero past the global edges
_MSDA_TILE_CASES = [(1, 48, 48, 42, 60, 96), (2, 48, 48, 16, 38, 48),
                    (4, 0, 48, -6, 24, 24), (8, 12, 12, 0, 12, 12),
                    (8, 0, 48, 0, 12, 12)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", _MSDA_TILE_CASES,
                         ids=["f1", "f2", "f4_top_edge", "f8_q0_12",
                              "f8_rank0_whole"])
@pytest.mark.parametrize("r", [5, 6])
def test_msda_kernels_on_a_tile(cuda, dtype, tile, r):
    """B5 and B5b at a rank's H tile (query rows from q0, the level map's
    rows from v0 with its halo rows; at f 8 from q0 12, not a multiple of
    f) match their plain versions at the forward and backward tolerances,
    B5b with its masks at r 5 and walking at r 6, and the same bits on a
    second launch."""
    f, q0, hq, v0, n, Hg = tile
    g = torch.Generator(device=cuda).manual_seed(70 + f)
    B, Wq, M, P, D = 16, 192, 8, 4, 8
    rows = torch.arange(v0, v0 + n, device=cuda)
    on_map = ((rows >= 0) & (rows < Hg)).float()[None, :, None, None]
    vmap = (torch.randn(B, n, Wq // f, M * D, generator=g, device=cuda)
            * on_map).to(dtype)
    dx, dy = ((torch.rand(B, hq, Wq, M * P, generator=g, device=cuda) * 2 - 1)
              * (r - 0.5) for _ in range(2))
    aw = torch.rand(B, hq, Wq, M * P, generator=g, device=cuda)
    gout = torch.randn(B, hq, Wq, M * D, generator=g, device=cuda).to(dtype)
    offsets = (q0, v0, Hg)
    got = msda.msda_taps(vmap, dx, dy, aw, M, r, *offsets)
    atol, rtol = _GPU_TOL[dtype]
    torch.testing.assert_close(
        got.float(), msda.msda_taps_plain(vmap, dx, dy, aw, M, r, *offsets).float(),
        atol=atol, rtol=rtol)
    args = (vmap, dx, dy, aw, gout, M, r, *offsets)
    got, ran = _ran("msda_taps_bwd", lambda: msda.msda_taps_bwd(*args))
    assert ran == {"vector_masks" if r <= 5 else "vector_walk": 1}, ran
    _check_msda_bwd(got, msda.msda_taps_bwd_plain(*args), dtype)
    for a, b in zip(got, msda.msda_taps_bwd(*args)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 4, 6), (8, 3, 8), (2, 5, 16)],
                         ids=["D6", "P3", "D16"])
@pytest.mark.parametrize("r", [4, 6])
def test_msda_bwd_kernel_off_the_training_shapes(cuda, dtype, shape, r):
    """B5b on its scalar path (D 6; P 3; D 16 with P 5) at level factor 3
    (9 queries a cell over 8 lanes), on ragged grids, with samples beyond
    r and past the borders; with the masks at r 4 and walking at r 6."""
    M, P, D = shape
    args = _msda_bwd_case(cuda, 40, 2, 27, 33, 3, M, P, D, 7.0, dtype)
    got, ran = _ran("msda_taps_bwd", lambda: msda.msda_taps_bwd(*args, M, r))
    assert ran == {"scalar_masks" if r <= 5 else "scalar_walk": 1}, ran
    _check_msda_bwd(got, msda.msda_taps_bwd_plain(*args, M, r), dtype)


@pytest.mark.gpu
def test_tap_level_gradients_through_the_kernels(cuda):
    """ms_deform_attn_taps with gradients on the card: through TapLevel on
    the kernels (one B5 and one B5b launch per level) and on the plain
    versions, the same gradients of value, locations and weights (f32)."""
    g = torch.Generator(device=cuda).manual_seed(41)
    levels, (Hq, Wq), M, D, P = [(24, 48), (12, 24)], (24, 48), 8, 8, 4
    value = torch.randn(2, sum(h * w for h, w in levels), M, D, generator=g,
                        device=cuda)
    ry, rx = torch.meshgrid((torch.arange(Hq, device=cuda) + 0.5) / Hq,
                            (torch.arange(Wq, device=cuda) + 0.5) / Wq,
                            indexing="ij")
    ref = torch.stack([rx.reshape(-1), ry.reshape(-1)], -1)
    norm = torch.tensor([[w, h] for h, w in levels], device=cuda)
    offs = (torch.rand(2, Hq * Wq, M, 2, P, 2, generator=g, device=cuda) * 2 - 1) * 4.5
    locs = ref[None, :, None, None, None] + offs / norm[:, None]
    w = torch.softmax(torch.randn(2, Hq * Wq, M, 2 * P, generator=g, device=cuda), -1)
    w = w.reshape(2, Hq * Wq, M, 2, P)
    cot = torch.randn(2, Hq * Wq, M * D, generator=g, device=cuda)
    grads = {}
    for use_kernels in (True, False):
        inputs = [t.clone().requires_grad_() for t in (value, locs, w)]
        before = _native.launch_counts()
        msda.ms_deform_attn_taps(inputs[0], levels, inputs[1], inputs[2],
                                 (Hq, Wq), 5, use_kernels).backward(cot)
        after = _native.launch_counts()
        want = 2 if use_kernels else 0
        assert after["msda_taps"] - before["msda_taps"] == want
        assert after["msda_taps_bwd"] - before["msda_taps_bwd"] == want
        grads[use_kernels] = [t.grad for t in inputs]
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _gloo_cuda_worker(rank, out_dir):
    """Which collectives gloo runs on CUDA tensors itself, and the port's
    collective layer on the card."""
    import json

    import torch.distributed as dist

    from nmrf_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, 2, backend="gloo")
    x = torch.full((4,), float(rank + 1), device=mesh.device)
    native = {}
    probes = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x),
    }
    for name, probe in probes.items():
        try:  # a probe of gloo itself, not a path of the port
            probe()
            torch.cuda.synchronize()
            native[name] = True
        except RuntimeError as err:
            native[name] = str(err).splitlines()[0]
    group = mesh.spatial_group
    gathered = [t.tolist() for t in group.all_gather(x)]
    reduced = group.all_reduce(x).tolist()
    with open(f"{out_dir}/gloo_{rank}.json", "w") as f:
        json.dump({"native": native, "gathered": gathered, "reduced": reduced}, f)


@pytest.mark.gpu
def test_gloo_collectives_on_cuda(cuda, tmp_path):
    """gloo runs all_reduce, broadcast and all_gather on CUDA tensors itself
    (so the collective layer copies nothing to the host), and the layer
    gives the right results on the card (two ranks on one card)."""
    import json

    from nmrf_tpu_torch.parallel import spawn

    spawn(_gloo_cuda_worker, 2, "gloo", args=(str(tmp_path),), timeout_s=120)
    for rank in range(2):
        got = json.loads((tmp_path / f"gloo_{rank}.json").read_text())
        print(rank, got["native"])
        assert got["native"] == dict.fromkeys(
            ("all_reduce", "broadcast", "all_gather"), True)
        assert got["gathered"] == [[1.0] * 4, [2.0] * 4]
        assert got["reduced"] == [3.0] * 4


def _sharded_small_worker(rank, out_dir, data, spatial):
    """A 2-layer model at 96x64, batch 2, through the kernels on a data x
    spatial grid: eval outputs and one step's loss, with the launch counts,
    against the unsharded model on rank 0."""
    import json

    from nmrf_tpu_torch.parallel import (make_mesh, make_sharded_forward,
                                         shard_batch, spatial_sharded_apply)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_cfg()
    cfg.NMP.NUM_PROP_LAYERS = cfg.NMP.NUM_INFER_LAYERS = 2
    cfg.NMP.NUM_REFINE_LAYERS = 2
    cfg.SOLVER.LOSS_WEIGHTS = [1.0, 1.2, 1.4, 2.0]
    cfg.DPN.MAX_DISP = 64
    cfg.SOLVER.MAX_DISP = 48
    cfg.TPU.MESH_DATA, cfg.TPU.MESH_SPATIAL = data, spatial
    mesh = make_mesh(data, spatial)
    model = build_model(cfg, mesh=mesh)
    batch = synthetic_batch(2, 96, 64, 48, seed=0)
    img1, img2 = (torch.from_numpy(batch[k]).to(mesh.device) for k in ("img1", "img2"))
    _native.reset_launch_counts()
    got = make_sharded_forward(model, mesh)(img1, img2)
    fwd_counts = _native.launch_counts()
    model.train()
    local = shard_batch(batch, mesh)
    _native.reset_launch_counts()
    loss = build_criterion(cfg)(spatial_sharded_apply(
        model, mesh, local["img1"], local["img2"]), local)["total"]
    loss.backward()
    step_counts = _native.launch_counts()
    result = {"fwd": fwd_counts, "step": step_counts, "loss": float(loss.detach())}
    if rank == 0:
        ref = build_model(cfg, device=mesh.device)
        with torch.inference_mode():
            want = ref(img1, img2)
        result["err"] = {k: (got[k].float() - want[k].float()).abs().max().item()
                         for k in ("prob", "proposal", "initial_proposal")}
        ref.train()
        tb = {k: torch.from_numpy(v).to(mesh.device) for k, v in batch.items()}
        result["ref_loss"] = float(build_criterion(cfg)(ref(tb["img1"], tb["img2"]),
                                                        tb)["total"].detach())
    with open(f"{out_dir}/sharded_{rank}.json", "w") as f:
        json.dump(result, f)


def _check_sharded_small(tmp_path, world):
    """Per rank 4 K1, 2 K2 and 2 B6 per forward, 4 K1b, 2 K2b and 2 B6b per
    backward; the outputs and the loss of the unsharded model."""
    import json

    fwd = dict.fromkeys(_native.launch_counts(), 0)
    fwd.update(window_attention=4, stripe_attention=2, masked_attention=2)
    step = dict(fwd, window_attention_bwd=4, stripe_attention_bwd=2,
                masked_attention_bwd=2)
    results = [json.loads((tmp_path / f"sharded_{r}.json").read_text())
               for r in range(world)]
    for res in results:
        assert res["fwd"] == fwd and res["step"] == step
    assert max(results[0]["err"].values()) < 1e-3, results[0]["err"]
    assert results[0]["loss"] == pytest.approx(results[0]["ref_loss"], rel=1e-4)
    for res in results[1:]:
        assert res["loss"] == results[0]["loss"]


@pytest.mark.gpu
def test_sharded_forward_and_step_on_one_card(cuda, tmp_path):
    """The 1 x 2 sharded path with both ranks on one card (gloo: NCCL
    refuses two ranks on one device) equals the unsharded model."""
    from nmrf_tpu_torch.parallel import spawn

    spawn(_sharded_small_worker, 2, "gloo", args=(str(tmp_path), 1, 2),
          timeout_s=300)
    _check_sharded_small(tmp_path, 2)


@pytest.mark.gpu
def test_sharded_nccl_one_card_per_rank(cuda, tmp_path):
    """The 2 x 2 grid (data and spatial axes) over NCCL, a card per rank,
    equals the unsharded model.  Needs four cards."""
    from nmrf_tpu_torch.parallel import spawn

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices (a card per rank of a 2 x 2 grid)")
    spawn(_sharded_small_worker, 4, "nccl", args=(str(tmp_path), 2, 2),
          timeout_s=300)
    _check_sharded_small(tmp_path, 4)


# ---- the serving kernels as registered operators, and the artifact ---- #

def _op_cases(device, dtype):
    """One call of each ``nmrf`` operator at small shapes: K1 at an
    Inference window (N 4, shift 3, candidate mask), K2 at a vertical
    stripe, B5 at the neck's widths (M 8, D 8, P 4, f 2, r 5)."""
    g = torch.Generator(device=device).manual_seed(9)
    qkv = torch.randn(1, 12, 18, 4, 384, generator=g, device=device).to(dtype)
    table = 0.5 * torch.randn(121, 384, generator=g, device=device)
    q, k, v = (torch.randn(1, 8, 6, 4, 64, generator=g, device=device).to(dtype)
               for _ in range(3))
    vmap = torch.randn(2, 12, 16, 64, generator=g, device=device).to(dtype)
    dx, dy = ((torch.rand(2, 24, 32, 32, generator=g, device=device) * 2 - 1)
              * 4.0 for _ in range(2))
    aw = torch.rand(2, 24, 32, 32, generator=g, device=device)
    return [(A.window_attention_op, (qkv, table, 3, [6, 6], 4, True, 0, None)),
            (A.stripe_attention_op, (q, k, v, 8, 1, 2)),
            (msda.msda_taps_op, (vmap, dx, dy, aw, 8, 5))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", [0, 1, 2],
                         ids=["window_attention", "stripe_attention", "msda_taps"])
def test_registered_ops_pass_opcheck(cuda, dtype, index):
    """``torch.library.opcheck`` on each operator (schema, fake
    implementation against the kernel, autograd registration, AOT
    dispatch), and the operator equals the wrapper's plain version."""
    op, args = _op_cases(cuda, dtype)[index]
    torch.library.opcheck(op, args)
    plain = (lambda *a: A.window_attention_plain(*a[:3], tuple(a[3]), *a[4:]),
             A.stripe_attention_plain, msda.msda_taps_plain)[index]
    atol, rtol = _GPU_TOL[dtype]
    torch.testing.assert_close(op(*args).float(), plain(*args).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("swin", [False, True], ids=["resnet", "swin"])
def test_exported_artifact_runs_the_kernels(cuda, swin, tmp_path):
    """A small model exported on the card (2 layers per NMP stage): the
    graph holds one ``nmrf`` node per launch, and the loaded artifact
    launches the kernels as many times and equals the live model."""
    from nmrf_tpu_torch.utils.export import (export_eval, load_exported,
                                             save_exported)

    cfg = get_cfg()
    if swin:
        cfg.merge_from_file(str(Path(__file__).resolve().parent.parent
                                / "configs" / "sceneflow_swint.yaml"))
    cfg.NMP.NUM_PROP_LAYERS = cfg.NMP.NUM_INFER_LAYERS = 2
    cfg.NMP.NUM_REFINE_LAYERS = 2
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    model = build_model(cfg, device=cuda)
    shape = (1, 64, 128, 3)
    exported = export_eval(model, shape)
    targets = [str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"]
    nodes = {name: sum(t == f"nmrf.{name}.default" for t in targets)
             for name in ("window_attention", "stripe_attention", "msda_taps")}
    assert nodes == {"window_attention": 4, "stripe_attention": 4,
                     "msda_taps": 4 if swin else 0}
    path = str(tmp_path / "model.pt2")
    save_exported(exported, path)
    module = load_exported(path).module()
    rng = np.random.RandomState(1)
    a, b = (torch.from_numpy((rng.rand(*shape) * 255).astype(np.float32))
            .to(cuda) for _ in range(2))
    _native.reset_launch_counts()
    with torch.no_grad():
        got = module(a, b)
    counts = _native.launch_counts()
    assert {k: counts[k] for k in nodes} == nodes
    with torch.no_grad():
        want = model(a, b)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    with pytest.raises(Exception):
        module(a[:, :32], b[:, :32])


# ---- predict's frames on the card ---- #

@pytest.mark.gpu
def test_predict_stages_frames_through_reused_pinned_buffers(cuda):
    """``predict`` on the card (2 layers per NMP stage, f32): a pinned
    staging buffer is allocated (``nmrf::predict.stage_alloc``) for the
    first request of a shape and dtype only; the model's input equals the
    CPU path's and the numpy prep's (``np.pad`` of the float32 cast) bit
    for bit; the disparity equals the same model's on the numpy prep bit
    for bit, a float32 caller's of the same values too, and the CPU
    model's up to the card's numerics (TF32 off)."""
    from torch.profiler import ProfilerActivity, profile

    from nmrf_tpu_torch import predict
    from nmrf_tpu_torch.data.frame_io import InputPadder

    cfg = get_cfg()
    cfg.NMP.NUM_PROP_LAYERS = cfg.NMP.NUM_INFER_LAYERS = 2
    cfg.NMP.NUM_REFINE_LAYERS = 2
    cpu_model = build_model(cfg, device="cpu")
    model = build_model(cfg, device=cuda)
    model.load_state_dict(cpu_model.state_dict())
    seen = []
    for m in (model, cpu_model):
        m.register_forward_pre_hook(
            lambda module, args: seen.append([x.cpu() for x in args]))
    rng = np.random.RandomState(3)
    pairs = [[rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
              for _ in range(2)] for h, w in ((60, 124), (60, 124), (92, 180))]
    pairs.append([x.astype(np.float32) for x in pairs[0]])
    allocs, disps = [], []
    for pair in pairs:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            disps.append(predict(model, *pair))
        allocs.append(sum(e.name == "nmrf::predict.stage_alloc"
                          for e in prof.events()))
    assert allocs == [1, 0, 1, 1]
    assert np.array_equal(disps[3], disps[0])

    padder = InputPadder(pairs[0][0].shape, mode="proposal",
                         divis_by=model.divis_by)
    a, b = (torch.from_numpy(p[None]).to(cuda) for p in padder.pad(
        *(np.asarray(x, np.float32) for x in pairs[0])))
    with torch.inference_mode():
        numpy_prep = padder.unpad(model(a, b)["disp"].float().cpu().numpy())[0]
    assert np.array_equal(disps[0], numpy_prep)
    on_cpu = predict(cpu_model, *pairs[0])
    for x, y, z in zip(seen[0], seen[-1], seen[-2]):
        assert x.dtype == torch.float32
        assert torch.equal(x, y) and torch.equal(x, z)
    gap = np.abs(disps[0] - on_cpu)
    assert np.quantile(gap, 0.9) < 1e-2, (np.median(gap), gap.max())


# ---- RAFT-Stereo's update loop from CUDA graphs ---- #

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_raft_update_loop_replays_graphs_to_the_bit(cuda, dtype):
    """RAFT-Stereo (4 iterations) with forward hooks on ``update_block``
    and the model, as the benchmark's generator registers them: three
    ``predict`` calls on the same 60x124 frames open
    ``nmrf::raft.graph_capture`` once, and each equals the eager loop (run
    while another call holds the graphs) in the disparity and every hooked
    tensor at every iteration (the taps and flow passed in, the states,
    mask and delta returned), to the bit; the first request's tensors are
    unchanged after the others; a new shape captures again; a forward
    under ``no_grad`` replays the same graphs, and one that records a
    gradient runs eagerly, both with the same bits."""
    from torch.profiler import ProfilerActivity, profile

    from nmrf_tpu_torch import predict

    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.ARCH", "raft_stereo", "RAFT.VALID_ITERS", 4,
                         "TPU.COMPUTE_DTYPE", dtype])
    model = build_model(cfg, device=cuda)
    kept = []
    model.update_block.register_forward_hook(
        lambda m, args, out: kept[-1]["calls"].append(
            (*args[2:], *out[0], out[1], out[2])))
    model.register_forward_hook(
        lambda m, args, out: kept[-1].update(out=out))

    def opened(fn):
        kept.append({"calls": []})
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
        kept[-1]["result"] = out
        return sum(e.name == "nmrf::raft.graph_capture"
                   for e in prof.events())

    def same(a, b):
        assert len(a["calls"]) == len(b["calls"]) == 4
        for x, y in zip(a["calls"], b["calls"]):
            assert all(torch.equal(s, t) for s, t in zip(x, y))
        for key in ("disp", "disp_lowres"):
            assert torch.equal(a["out"][key].detach(), b["out"][key]), key

    rng = np.random.RandomState(5)
    pair = [rng.randint(0, 256, (60, 124, 3)).astype(np.uint8)
            for _ in range(2)]
    with model.update_graphs.hold("another call", object):
        assert opened(lambda: predict(model, *pair)) == 0
    eager = kept.pop()
    assert [opened(lambda: predict(model, *pair)) for _ in range(3)] == \
        [1, 0, 0]
    first = [[t.clone() for t in call] for call in kept[0]["calls"]]
    for k in kept:
        same(k, eager)
        assert np.array_equal(k["result"], eager["result"])
    for call, copy in zip(kept[0]["calls"], first):
        assert all(torch.equal(t, c) for t, c in zip(call, copy))
    assert len(model.update_graphs) == 2  # "another call"'s and the shape's

    a, b = (torch.from_numpy(np.pad(x.astype(np.float32),
                                    ((0, 4), (0, 4), (0, 0)), mode="edge")
                             [None]).to(cuda) for x in pair)
    with torch.no_grad():
        assert opened(lambda: model(a, b)) == 0
    same(kept[-1], eager)
    with torch.enable_grad():
        assert opened(lambda: model(a, b)) == 0
    same(kept[-1], eager)
    other = [rng.randint(0, 256, (92, 180, 3)).astype(np.uint8)
             for _ in range(2)]
    assert opened(lambda: predict(model, *other)) == 1
    assert opened(lambda: predict(model, *other)) == 0
    assert len(model.update_graphs) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_igev_update_loop_replays_graphs_to_the_bit(cuda, dtype):
    """IGEV-Stereo (4 iterations) through RAFT-Stereo's loop graphs, with
    forward hooks on ``update_block``, ``desc``, ``cost_agg`` and the
    model, as the benchmark's generator registers them: three ``predict``
    calls on the same 60x124 frames open ``nmrf::igev.graph_capture`` once,
    and each equals the eager loop (run while another call holds the
    graphs) in the disparity and every hooked tensor, to the bit; the first
    request's tensors are unchanged after the others (nothing handed out is
    a graph's buffer); a forward that records a gradient runs eagerly with
    the same bits.  cuDNN runs deterministic algorithms here: in float32 it
    may run the volume stage's transposed 3-D convolutions with a
    backward-data algorithm that adds in another order from run to run, and
    what is compared is the loop's graphs against the eager loop, not two
    runs of the volume."""
    from torch.profiler import ProfilerActivity, profile

    from nmrf_tpu_torch import predict

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _igev_update_loop_to_the_bit(cuda, dtype, predict, profile,
                                     ProfilerActivity)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _igev_update_loop_to_the_bit(cuda, dtype, predict, profile,
                                 ProfilerActivity):
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.ARCH", "igev_stereo", "RAFT.CORR_LEVELS", 2,
                         "RAFT.VALID_ITERS", 4, "TPU.COMPUTE_DTYPE", dtype])
    model = build_model(cfg, device=cuda)
    kept = []
    model.update_block.register_forward_hook(
        lambda m, args, out: kept[-1]["calls"].append(
            (*args[2:], *out[0], out[1], out[2])))
    for name in ("desc", "cost_agg"):
        model.get_submodule(name).register_forward_hook(
            lambda m, args, out, name=name: kept[-1].update({name: out}))
    model.register_forward_hook(
        lambda m, args, out: kept[-1].update(out=out))

    def opened(fn):
        kept.append({"calls": []})
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
        kept[-1]["result"] = out
        return sum(e.name == "nmrf::igev.graph_capture"
                   for e in prof.events())

    def same(a, b):
        assert len(a["calls"]) == len(b["calls"]) == 4
        for x, y in zip(a["calls"], b["calls"]):
            assert all(torch.equal(s, t) for s, t in zip(x, y))
        for key in ("disp", "disp_lowres", "init_disp"):
            assert torch.equal(a["out"][key].detach(), b["out"][key]), key
        for key in ("desc", "cost_agg"):
            assert torch.equal(a[key].detach(), b[key]), key

    rng = np.random.RandomState(7)
    pair = [rng.randint(0, 256, (60, 124, 3)).astype(np.uint8)
            for _ in range(2)]
    with model.update_graphs.hold("another call", object):
        assert opened(lambda: predict(model, *pair)) == 0
    eager = kept.pop()
    assert [opened(lambda: predict(model, *pair)) for _ in range(3)] == \
        [1, 0, 0]
    first = [[t.clone() for t in call] for call in kept[0]["calls"]]
    for k in kept:
        same(k, eager)
        assert np.array_equal(k["result"], eager["result"])
    for call, copy in zip(kept[0]["calls"], first):
        assert all(torch.equal(t, c) for t, c in zip(call, copy))
    a, b = (torch.from_numpy(np.pad(x.astype(np.float32),
                                    ((0, 4), (0, 4), (0, 0)), mode="edge")
                             [None]).to(cuda) for x in pair)
    with torch.enable_grad():
        assert opened(lambda: model(a, b)) == 0
    same(kept[-1], eager)


# ---- NMRF's forward from CUDA graphs ---- #

@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["resnet", "swin"])
def test_nmrf_forward_replays_graphs_to_the_bit(cuda, variant):
    """``predict`` at 375x1242 with the served configuration (bf16, the
    tanh GELU, the kernels; swin at tap radius 5) and the benchmark's
    forward hooks (``benchmark/traffic/serve_stream.py:_hooks``): three
    requests open ``nmrf::graph_capture`` on the first only; each equals a
    request while another call holds the graphs (the eager forward) in the
    disparity and every hooked tensor, to the bit, and counts each of the
    port's kernels as often (10 K1, 10 K2 and, swin, 4 B5 a request; the
    capturing request too: a graph's warm-up and capture count none); the
    first request's tensors are unchanged after the others."""
    from torch.profiler import ProfilerActivity, profile

    from nmrf_tpu_torch import predict

    cfg = get_cfg()
    if variant == "swin":
        cfg.merge_from_file(str(Path(__file__).resolve().parent.parent
                                / "configs" / "sceneflow_swint.yaml"))
        cfg.TPU.MSDA_TAP_RADIUS = 5
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.GELU_APPROX = True
    cfg.TPU.USE_PALLAS = True
    model = build_model(cfg, device=cuda)
    kept = []

    def hook(key, pick):
        def fn(module, args, out):
            kept[-1][key] = pick(out)
        return fn

    model.backbone.register_forward_hook(hook("features", lambda o: o[1]))
    model.inference.register_forward_hook(hook("inference", lambda o: o[0]))
    model.infer_head.register_forward_hook(hook("head", lambda o: o[-1]))
    model.infer_score_head.register_forward_hook(hook("score",
                                                      lambda o: o[-1]))
    model.refinement.register_forward_hook(hook("refinement", lambda o: o[0]))
    for key in ("prob", "proposal", "disp"):
        model.register_forward_hook(hook(key, lambda o, key=key: o[key]))

    def request(pair):
        kept.append({})
        _native.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            kept[-1]["result"] = torch.from_numpy(predict(model, *pair))
        kept[-1]["launches"] = {k: n for k, n in
                                _native.launch_counts().items() if n}
        return sum(e.name == "nmrf::graph_capture" for e in prof.events())

    rng = np.random.RandomState(11)
    pair = [rng.randint(0, 256, (375, 1242, 3)).astype(np.uint8)
            for _ in range(2)]
    with model.forward_graphs.hold("another call", object):
        assert request(pair) == 0
        assert request(pair) == 0
    eager = kept.pop()
    kept.clear()
    assert eager["launches"] == {"window_attention": 10,
                                 "stripe_attention": 10,
                                 **({"msda_taps": 4} if variant == "swin"
                                    else {})}
    opened = [request(pair) for _ in range(3)]
    assert opened[0] > 0 and opened[1:] == [0, 0]
    first = {k: v.clone() for k, v in kept[0].items() if k != "launches"}
    for k in kept:
        for key in first:
            assert torch.equal(k[key], eager[key]), key
    for k in kept:
        assert k["launches"] == eager["launches"]
    for key, value in first.items():
        assert torch.equal(kept[0][key], value), key
