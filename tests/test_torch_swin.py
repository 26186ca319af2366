"""The port's swin variant against the JAX package (CPU, float32).

Modules: the flax params (random, plus seeded noise on every leaf so the
zero-initialised offsets, weights, tables and biases are exercised) go
through ``params_from_jax`` into the port module; both see the same numpy
inputs.  The JAX deformable attention takes its tap path (the Pallas tap
kernel in interpret mode) wherever the port's does.  Tolerance: atol = rtol
= 1e-4 (the same f32 math in another summation order).

The whole slice: the swin config (``configs/sceneflow_swint.yaml``) at
64 x 128 with 2 layers per NMP stage, tap radius 5, JAX with its Pallas
kernels: the weight round trip is exact, and the forward matches at the
tolerances of ``tests/test_torch_model.py`` (strict on prob and proposals,
tie-aware on the disparity).
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from nmrf_tpu.config import get_cfg as get_cfg_jax
from nmrf_tpu.models import adaptor as adaptor_jax
from nmrf_tpu.models import build_model as build_model_jax
from nmrf_tpu.models import swin as swin_jax
from nmrf_tpu.utils.checkpoint import convert_torch_state_dict
from nmrf_tpu_torch import build_model, get_cfg, predict
from nmrf_tpu_torch.models import adaptor, swin
from nmrf_tpu_torch.models.layers import DropPath, DropPathMasks
from nmrf_tpu_torch.utils.convert import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-4, rtol=1e-4)
H, W = 64, 128


def _load(module, params, scale=0.05):
    """Noisy copy of a flax param tree -> port module (strict)."""
    rng = np.random.RandomState(11)
    noisy = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.randn(*x.shape).astype(np.float32),
        params["params"])
    state = {k[len("m."):]: v for k, v in params_from_jax({"m": noisy}).items()}
    module.load_state_dict(state, strict=True)
    return {"params": jax.tree_util.tree_map(jnp.asarray, noisy)}


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _port(module, *args):
    module.eval()
    with torch.inference_mode():
        out = module(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                       for a in args])
    if isinstance(out, (list, tuple)):
        return [o.numpy() for o in out]
    return out.numpy()


def _jitted(fn, first, args):
    """fn(first, *args), jitted over the array arguments (the others
    static)."""
    arrays = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]

    def call(p, *xs):
        full = list(args)
        for i, x in zip(arrays, xs):
            full[i] = x
        return fn(p, *full)

    return jax.jit(call)(first, *(jnp.asarray(args[i]) for i in arrays))


def _init(module, seed, *args):
    return _jitted(module.init, jax.random.PRNGKey(seed), args)


def _jax(module, params, *args):
    out = _jitted(module.apply, params, args)
    if isinstance(out, dict):
        return [np.asarray(out[f"p{i}"]) for i in range(len(out))]
    if isinstance(out, (list, tuple)):
        return [np.asarray(o) for o in out]
    return np.asarray(out)


def _ref_points(Hq, Wq):
    return np.array(adaptor_jax.get_reference_points([(Hq, Wq)]))


# --------------------------------------------------------------------------- #
# adaptor modules (dim 32, 4 heads; query grid 8 x 16)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("radius", [5, 0], ids=["taps", "exact"])
@pytest.mark.parametrize("level", [(8, 16), (2, 4)], ids=["f1", "f4"])
def test_ms_deform_attn(level, radius):
    rng = np.random.RandomState(0)
    q, feat = _rand(rng, 2, 128, 32), _rand(rng, 2, level[0] * level[1], 32)
    ref = _ref_points(8, 16)
    jm = adaptor_jax.MSDeformAttn(32, 1, 4, 4, 0.5, tap_radius=radius)
    params = _init(jm, 0, q, ref, feat, [level], (8, 16))
    pm = adaptor.MSDeformAttn(32, 1, 4, 4, 0.5, tap_radius=radius,
                              use_kernels=True)
    params = _load(pm, params)
    want = _jax(jm, params, q, ref, feat, [level], (8, 16))
    got = _port(pm, q, torch.from_numpy(ref), feat, [level], (8, 16))
    assert pm.uses_taps(128, [level], (8, 16)) == (radius > 0)
    np.testing.assert_allclose(got, want, **TOL)


def test_tap_path_needs_a_whole_level_factor():
    """At KITTI size the neck takes the tap path only when the request is
    padded to /32 (query grid 96 x 312 over the 12 x 39 level); padded to /8
    (94 x 312) it would fall back to the exact path and B5 would not run."""
    m = adaptor.MSDeformAttn(32, 1, 4, 4, 0.5, tap_radius=5)
    assert m.uses_taps(96 * 312, [(12, 39)], (96, 312))
    assert not m.uses_taps(94 * 312, [(12, 39)], (94, 312))


def test_conv_ffn():
    rng = np.random.RandomState(1)
    x = _rand(rng, 2, 8 * 12, 32)
    jm = adaptor_jax.ConvFFN(8, 32)
    params = _init(jm, 1, x, 8, 12)
    pm = adaptor.ConvFFN(32, 8, 32)
    params = _load(pm, params)
    np.testing.assert_allclose(_port(pm, x, 8, 12), _jax(jm, params, x, 8, 12),
                               **TOL)


def test_extractor():
    rng = np.random.RandomState(2)
    q, feat = _rand(rng, 2, 128, 32), _rand(rng, 2, 32, 32)
    ref = _ref_points(8, 16)
    jm = adaptor_jax.Extractor(32, 4, 4, 1, 0.5, tap_radius=5)
    params = _init(jm, 2, q, ref, feat, [(4, 8)], 8, 16)
    pm = adaptor.Extractor(32, 4, 4, 1, 0.5, tap_radius=5, use_kernels=True)
    params = _load(pm, params)
    want = _jax(jm, params, q, ref, feat, [(4, 8)], 8, 16)
    got = _port(pm, q, torch.from_numpy(ref), feat, [(4, 8)], 8, 16)
    np.testing.assert_allclose(got, want, **TOL)


def test_conv_stem():
    rng = np.random.RandomState(3)
    img = _rand(rng, 2, 32, 64, 3)
    jm = adaptor_jax.ConvStem(64, 32)
    params = _init(jm, 3, img)
    pm = adaptor.ConvStem(64, 32)
    params = _load(pm, params)
    np.testing.assert_allclose(_port(pm, img), _jax(jm, params, img), **TOL)


def test_deform_neck():
    """Four levels at f = 1, 2, 4, 8 over the 8 x 16 query grid."""
    rng = np.random.RandomState(4)
    img = _rand(rng, 2, 32, 64, 3)
    feats = [_rand(rng, 2, 8 // s, 16 // s, c)
             for s, c in ((1, 8), (2, 16), (4, 24), (8, 32))]
    jm = adaptor_jax.DeformNeck(32, [8, 16, 24, 32], num_heads=4,
                                deform_ratio=0.5, tap_radius=5)
    params = _init(jm, 4, img, feats)
    pm = adaptor.DeformNeck(32, [8, 16, 24, 32], num_heads=4, deform_ratio=0.5,
                            tap_radius=5, use_kernels=True)
    params = _load(pm, params)
    want = _jax(jm, params, img, feats)
    with torch.inference_mode():
        got = pm(torch.from_numpy(img), [torch.from_numpy(f) for f in feats])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# --------------------------------------------------------------------------- #
# Swin-T modules
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("shifted", [False, True])
def test_swin_window_attention(shifted):
    rng = np.random.RandomState(5)
    x = _rand(rng, 8, 49, 16)
    mask = swin.swin_shift_mask(14, 14, 7, 3) if shifted else None
    np.testing.assert_array_equal(
        swin.swin_shift_mask(14, 14, 7, 3), swin_jax._swin_shift_mask(14, 14, 7, 3))
    jm = swin_jax.WindowAttention(16, 7, 2)
    params = _init(jm, 5, x, mask)
    pm = swin.WindowAttention(16, 7, 2)
    params = _load(pm, params)
    want = _jax(jm, params, x, mask)
    got = _port(pm, x, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shift", [0, 3])
def test_swin_block(shift):
    """10 x 12 needs padding to 14 x 14 windows of 7."""
    rng = np.random.RandomState(6)
    x = _rand(rng, 2, 10, 12, 16)
    jm = swin_jax.SwinBlock(16, 2, 7, shift)
    params = _init(jm, 6, x)
    pm = swin.SwinBlock(16, 2, 7, shift)
    params = _load(pm, params)
    np.testing.assert_allclose(_port(pm, x), _jax(jm, params, x), **TOL)


def test_patch_merging_odd_sizes():
    rng = np.random.RandomState(7)
    x = _rand(rng, 2, 5, 7, 8)
    jm = swin_jax.PatchMerging(8)
    params = _init(jm, 7, x)
    pm = swin.PatchMerging(8)
    params = _load(pm, params)
    got = _port(pm, x)
    assert got.shape == (2, 3, 4, 16)
    np.testing.assert_allclose(got, _jax(jm, params, x), **TOL)


def test_swin_transformer_reduced():
    rng = np.random.RandomState(8)
    x = _rand(rng, 1, 64, 96, 3)
    kw = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(2, 2, 4, 4),
              drop_path_rate=0.2)
    jm = swin_jax.SwinTransformer(**kw)
    params = _init(jm, 8, x)
    pm = swin.SwinTransformer(**kw)
    params = _load(pm, params)
    got, want = _port(pm, x), _jax(jm, params, x)
    assert [g.shape for g in got] == [(1, 16, 24, 16), (1, 8, 12, 32),
                                      (1, 4, 6, 64), (1, 2, 3, 128)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


# --------------------------------------------------------------------------- #
# the whole slice
# --------------------------------------------------------------------------- #

def _swin_cfg(cfg):
    cfg.merge_from_file(str(ROOT / "configs" / "sceneflow_swint.yaml"))
    cfg.NMP.NUM_PROP_LAYERS = 2
    cfg.NMP.NUM_INFER_LAYERS = 2
    cfg.NMP.NUM_REFINE_LAYERS = 2
    cfg.TPU.USE_PALLAS = True
    return cfg


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(7)
    return tuple((rng.rand(1, H, W, 3) * 255).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def jax_model():
    cfg = _swin_cfg(get_cfg_jax())
    cfg.freeze()
    model, _ = build_model_jax(cfg)
    zeros = jnp.zeros((1, H, W, 3))
    params = jax.jit(lambda r: model.init(r, zeros, zeros, train=False))(
        jax.random.PRNGKey(0))
    return model, jax.tree_util.tree_map(np.asarray, dict(params))


@pytest.fixture(scope="module")
def noisy_params(jax_model):
    rng = np.random.RandomState(1)
    return jax.tree_util.tree_map(
        lambda x: x + 0.02 * rng.randn(*x.shape).astype(np.float32),
        jax_model[1])


@pytest.fixture(scope="module")
def port_model(noisy_params):
    model = build_model(_swin_cfg(get_cfg()), device="cpu")
    model.load_state_dict(params_from_jax(noisy_params), strict=True)
    return model


def _forward(model, images):
    with torch.inference_mode():
        out = model(*(torch.from_numpy(x) for x in images))
    return {k: v.float().numpy() for k, v in out.items()}


def test_weight_round_trip_is_exact(jax_model):
    params = jax_model[1]
    model = build_model(_swin_cfg(get_cfg()), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    back, unmatched = convert_torch_state_dict(model.state_dict())
    assert unmatched == []
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for path, value in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), value,
                                      err_msg=jax.tree_util.keystr(path))


def test_swin_adaptor_matches_jax(noisy_params, port_model, images):
    """The backbone alone, at its fixed Swin-T widths, on the slice's
    weights: both outputs (1/4 and 1/8 resolution) of both images."""
    x = np.concatenate(images)
    jm = adaptor_jax.SwinAdaptor(128, drop_path_rate=0.4, tap_radius=5)
    params = {"params": jax.tree_util.tree_map(
        jnp.asarray, noisy_params["params"]["backbone"])}
    want = jax.jit(lambda p, a: jm.apply(p, a))(params, jnp.asarray(x))
    got = _port(port_model.backbone, x)
    assert got[0].shape == (2, H // 4, W // 4, 128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_slice_matches_jax(jax_model, noisy_params, port_model, images):
    model, _ = jax_model
    params = jax.tree_util.tree_map(jnp.asarray, noisy_params)
    a, b = (jnp.asarray(x) for x in images)
    want = jax.jit(lambda p, a, b: model.apply(p, a, b, train=False))(params, a, b)
    want = {k: np.asarray(v) for k, v in want.items()}
    # the port's final selection logits locate the argmax near-ties (they
    # equal JAX's to f32 rounding)
    scores = []
    handle = port_model.infer_score_head.register_forward_hook(
        lambda _m, _i, out: scores.append(out))
    try:
        got = _forward(port_model, images)
    finally:
        handle.remove()

    np.testing.assert_allclose(got["prob"], want["prob"], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got["initial_proposal"], want["initial_proposal"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["proposal"], want["proposal"], atol=1e-3,
                               rtol=0)
    # disparity: mismatches only where an argmax near-tie can flip the
    # selected proposal (refinement receptive field 96 px around it)
    logits = scores[0][-1]  # [B, h8, w8, N, 64] -> [B, H, W, N]
    B, h8, w8, N, _ = logits.shape
    logits = logits.reshape(B, h8, w8, N, 8, 8).permute(0, 1, 4, 2, 5, 3)
    logits = logits.reshape(B, h8 * 8, w8 * 8, N).numpy()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    near_tie = torch.from_numpy((top2[..., 1] - top2[..., 0] < 1e-5)
                                .astype(np.float32))
    tie_region = (F.max_pool2d(near_tie[:, None], 193, 1, 96)[:, 0] > 0).numpy()
    for key, tol in (("disp", 4e-3), ("disp_pred", 1e-3)):
        bad = np.abs(got[key] - want[key]) > tol
        assert not bad[~tie_region].any(), key
        assert bad.mean() < 0.10, key


def test_bf16_forward_close_to_f32(port_model, images):
    """bf16 compute with tanh GELU against the same weights in f32, with the
    bounds of ``tests/test_torch_model.py``: every output finite, the
    disparity non-negative with a median error below 1 px, probabilities
    within 0.1 everywhere and 1e-3 on average."""
    cfg = _swin_cfg(get_cfg())
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.GELU_APPROX = True
    bf16 = build_model(cfg, device="cpu")
    bf16.load_state_dict(port_model.state_dict())
    got, ref = _forward(bf16, images), _forward(port_model, images)
    for key in ("disp", "prob", "proposal"):
        assert np.isfinite(got[key]).all(), key
    assert (got["disp"] >= 0).all()
    prob_err = np.abs(got["prob"] - ref["prob"])
    assert prob_err.max() < 0.1 and prob_err.mean() < 1e-3
    assert np.median(np.abs(got["disp"] - ref["disp"])) < 1.0


@pytest.mark.parametrize("size", [(61, 125), (61, 100)])
def test_predict_pads_to_32_and_unpads(port_model, size):
    """``predict`` pads to the config's DIVIS_BY (32): 61 x 100 becomes
    64 x 128, where a divisor of 8 would give 64 x 104."""
    rng = np.random.RandomState(3)
    img1, img2 = ((rng.rand(*size, 3) * 255).astype(np.float32) for _ in range(2))
    seen = []
    handle = port_model.register_forward_pre_hook(
        lambda _m, args: seen.append(tuple(args[0].shape)))
    try:
        disp = predict(port_model, img1, img2)
    finally:
        handle.remove()
    assert seen == [(1, 64, 128, 3)]
    assert disp.shape == size and disp.dtype == np.float32
    assert np.isfinite(disp).all() and (disp >= 0).all()


def test_drop_path_is_accepted_for_serving_and_refused_in_training(port_model):
    """``BACKBONE.DROP_PATH 0.4``: rates rise from 0 to 0.4 over the Swin
    blocks and every drop-path of the model draws from its seeded mask
    source.  A drop-path is the identity in eval mode and at rate 0; in
    training each call draws its own per-sample mask of shape (B, 1, ...)
    and returns x / keep where kept and 0 elsewhere, in x's dtype; without a
    mask source it raises rather than fall back to a global generator."""
    blocks = [b for layer in port_model.backbone.backbone.layers
              for b in layer.blocks]
    assert blocks[0].drop_path.rate == 0.0
    assert blocks[-1].drop_path.rate == pytest.approx(0.4)
    assert all(m.masks is port_model.drop_path_masks
               for m in port_model.modules() if isinstance(m, DropPath))
    x = torch.randn(64, 3, 4, 5)
    dp = DropPath(0.25)
    dp.masks = DropPathMasks(torch.Generator().manual_seed(0))
    assert dp.eval()(x) is x
    assert DropPath(0.0).train()(x) is x
    dp.train()
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        state = dp.masks.generator.get_state()
        out = dp(xd)
        want_mask = torch.rand(64, generator=torch.Generator().set_state(state)) < 0.75
        assert out.dtype == dtype
        kept = want_mask.reshape(64, 1, 1, 1)
        torch.testing.assert_close(out, torch.where(kept, xd / 0.75, 0.0),
                                   atol=0, rtol=0)
        assert 0 < int(want_mask.sum()) < 64
    assert not torch.equal(dp(x) == 0, dp(x) == 0)  # a new mask each call
    dp.masks = None
    with pytest.raises(RuntimeError, match="mask source"):
        dp(x)
