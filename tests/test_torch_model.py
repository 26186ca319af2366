"""The port's whole slice against the JAX package (CPU, 64 x 128 images,
2 layers per NMP stage so both shift parities run and H/8 = 8 needs window
padding at window 6).

* weights: JAX init params -> ``params_from_jax`` -> strict
  ``load_state_dict`` -> the JAX package's ``convert_torch_state_dict``
  gives back the original tree bit for bit, with nothing unmatched;
* forward: port vs JAX on the same (noisy) params in float32, with the
  tolerances of ``tests/test_fullmodel_parity.py:146-182`` (strict on
  prob and proposals, tie-aware on the disparity);
* bf16: the port's bf16 forward stays finite and close to its own f32 one.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from nmrf_tpu.config import get_cfg as get_cfg_jax
from nmrf_tpu.models import build_model as build_model_jax
from nmrf_tpu.utils.checkpoint import convert_torch_state_dict
from nmrf_tpu_torch import build_model, get_cfg, predict
from nmrf_tpu_torch.utils.convert import params_from_jax

H, W = 64, 128


def _small(cfg, use_pallas=True):
    cfg.NMP.NUM_PROP_LAYERS = 2
    cfg.NMP.NUM_INFER_LAYERS = 2
    cfg.NMP.NUM_REFINE_LAYERS = 2
    cfg.TPU.USE_PALLAS = use_pallas
    return cfg


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(7)
    return tuple((rng.rand(1, H, W, 3) * 255).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def jax_model():
    cfg = _small(get_cfg_jax())
    cfg.freeze()
    model, _ = build_model_jax(cfg)
    zeros = jnp.zeros((1, H, W, 3))
    params = jax.jit(lambda r: model.init(r, zeros, zeros, train=False))(
        jax.random.PRNGKey(0))
    return model, jax.tree_util.tree_map(np.asarray, dict(params))


@pytest.fixture(scope="module")
def noisy_params(jax_model):
    """Init params plus seeded noise, so zero-initialised tables, biases and
    the zero last layer of the DPN head are exercised."""
    rng = np.random.RandomState(1)
    return jax.tree_util.tree_map(
        lambda x: x + 0.02 * rng.randn(*x.shape).astype(np.float32),
        jax_model[1])


@pytest.fixture(scope="module")
def port_model(noisy_params):
    model = build_model(_small(get_cfg()), device="cpu")
    model.load_state_dict(params_from_jax(noisy_params), strict=True)
    return model


def _forward(model, images):
    with torch.inference_mode():
        out = model(*(torch.from_numpy(x) for x in images))
    return {k: v.float().numpy() for k, v in out.items()}


def test_weight_round_trip_is_exact(jax_model):
    params = jax_model[1]
    model = build_model(_small(get_cfg()), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    back, unmatched = convert_torch_state_dict(model.state_dict())
    assert unmatched == []
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for path, value in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), value,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_slice_matches_jax(jax_model, noisy_params, port_model, images,
                           use_pallas):
    cfg = _small(get_cfg_jax(), use_pallas)
    cfg.freeze()
    model, _ = build_model_jax(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, noisy_params)
    want = jax.jit(lambda p, a, b: model.apply(p, a, b, train=False))(
        params, *(jnp.asarray(x) for x in images))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = _forward(port_model, images)

    np.testing.assert_allclose(got["prob"], want["prob"], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got["initial_proposal"], want["initial_proposal"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["proposal"], want["proposal"],
                               atol=1e-3, rtol=0)
    # disparity: mismatches only where an argmax near-tie can flip the
    # selected proposal (refinement receptive field 96 px around it)
    logits = _jax_final_logits(model, params, images)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    near_tie = torch.from_numpy((top2[..., 1] - top2[..., 0] < 1e-5)
                                .astype(np.float32))
    tie_region = (F.max_pool2d(near_tie[:, None], 193, 1, 96)[:, 0] > 0).numpy()
    for key, tol in (("disp", 4e-3), ("disp_pred", 1e-3)):
        bad = np.abs(got[key] - want[key]) > tol
        assert not bad[~tie_region].any(), key
        assert bad.mean() < 0.10, key


def _jax_final_logits(model, params, images):
    out = jax.jit(lambda p, a, b: model.apply(
        p, a, b, train=True, rngs={"dropout": jax.random.PRNGKey(0)}))(
        params, *(jnp.asarray(x) for x in images))
    return np.asarray(out["logits_layers"][-1])


def test_bf16_forward_close_to_f32(port_model, images):
    """bf16 compute with tanh GELU against the same weights in f32.  bf16
    keeps 8 significant bits: cost logits of magnitude ~10 move by ~0.04,
    so one probability may move by up to ~0.1 while the mean stays below
    1e-3.  The disparity must stay finite and non-negative with a median
    error below 1 px (argmax flips between near-equal proposals move single
    pixels much further)."""
    cfg = _small(get_cfg())
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


def test_predict_unpads(port_model):
    rng = np.random.RandomState(3)
    img1, img2 = ((rng.rand(61, 125, 3) * 255).astype(np.float32) for _ in range(2))
    disp = predict(port_model, img1, img2)
    assert disp.shape == (61, 125) and disp.dtype == np.float32
    assert np.isfinite(disp).all() and (disp >= 0).all()


def test_build_model_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(_small(get_cfg()))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(_small(get_cfg()), device="cuda")
