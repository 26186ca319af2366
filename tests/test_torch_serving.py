"""The port's serving path against the JAX package (CPU): the exported
artifact (``nmrf_tpu_torch/utils/export.py``), the HTTP server
(``nmrf_tpu_torch/tools/serve_http.py``) and the registered operators
(``nmrf_tpu_torch/ops/library.py``), mirroring ``tests/test_export.py``.

Small config of ``tests/test_export.py`` (``DPN.MAX_DISP`` 64,
``SOLVER.MAX_DISP`` 48, 32 x 64 images), JAX init weights plus seeded noise
carried to the port by ``params_from_jax``.  Tolerances:

* the artifact against the live port model on the same device: atol 0
  (the same operations in the same order), frozen and hot-swapped;
* the port against the JAX package (its eval and its ``export_eval``
  artifact): the slice tolerances of ``tests/test_fullmodel_parity.py:
  146-182``, strict on prob (atol 2e-4, rtol 1e-3) and the proposals
  (1e-3), the disparity tie-aware (4e-3 outside the refinement's reach of
  an argmax near-tie, which the port's own final logits locate).

On the CPU the graph holds the kernels' plain versions (the operators have
no CPU implementation); ``tests/test_torch_gpu.py`` exports on the card,
``tests/test_torch_serving_swin.py`` exports the swin variant.
"""

import io
import json
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from nmrf_tpu.config import get_cfg as get_cfg_jax
from nmrf_tpu.models import build_model as build_model_jax
from nmrf_tpu.utils import export as export_jax
from nmrf_tpu_torch import build_model, get_cfg, predict
from nmrf_tpu_torch.ops import attention as A
from nmrf_tpu_torch.ops import msda
from nmrf_tpu_torch.tools import serve_http
from nmrf_tpu_torch.utils.convert import params_from_jax
from nmrf_tpu_torch.utils.export import (MAGIC, export_eval, load_exported,
                                         load_meta, save_exported)

SHAPE = (1, 32, 64, 3)
OPTS = ["DPN.MAX_DISP", "64", "SOLVER.MAX_DISP", "48"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (the suite runs a test process per core or so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _noisy(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rng.randn(*x.shape).astype(np.float32),
        dict(params))


def _port_model(params):
    cfg = get_cfg()
    cfg.merge_from_list(OPTS)
    cfg.freeze()
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


@pytest.fixture(scope="module")
def setup():
    cfg = get_cfg_jax()
    cfg.merge_from_list(OPTS)
    cfg.freeze()
    model_jax, _ = build_model_jax(cfg)
    rng = np.random.RandomState(3)
    images = tuple((rng.rand(*SHAPE) * 255).astype(np.float32) for _ in range(2))
    zeros = jnp.zeros(SHAPE)
    params = _noisy(jax.jit(lambda r: model_jax.init(
        r, zeros, zeros, train=False))(jax.random.PRNGKey(0)), 1)
    apply = jax.jit(lambda p, a, b: model_jax.apply(p, a, b, train=False))
    return model_jax, params, apply, images, _port_model(params)


@pytest.fixture(scope="module")
def artifact(setup, tmp_path_factory):
    """The frozen artifact of the port model, saved and loaded again:
    (path, loaded ExportedProgram)."""
    model = setup[-1]
    path = str(tmp_path_factory.mktemp("artifact") / "model.pt2")
    size = save_exported(export_eval(model, SHAPE), path,
                         extra_meta={"divis_by": 8})
    assert size > 0
    return path, load_exported(path)


def _torch(images):
    return tuple(torch.from_numpy(x) for x in images)


def _live(model, images):
    with torch.no_grad():
        return model(*_torch(images))


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _assert_matches_jax(got, want, model, images):
    """The slice tolerances (module docstring) on [B, H, W] disparities
    that may be a crop of the model's output at ``images``."""
    got = {k: np.asarray(v, np.float32) for k, v in got.items()}
    want = {k: np.asarray(v, np.float32) for k, v in want.items()}
    for key, atol, rtol in (("prob", 2e-4, 1e-3), ("initial_proposal", 1e-3, 0),
                            ("proposal", 1e-3, 0)):
        if key in want:
            np.testing.assert_allclose(got[key], want[key], atol=atol,
                                       rtol=rtol, err_msg=key)
    model.train()
    try:
        with torch.no_grad():
            logits = model(*_torch(images))["logits_layers"][-1].numpy()
    finally:
        model.eval()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    near_tie = torch.from_numpy((top2[..., 1] - top2[..., 0] < 1e-5)
                                .astype(np.float32))
    tie_region = (F.max_pool2d(near_tie[:, None], 193, 1, 96)[:, 0] > 0).numpy()
    H, W = want["disp"].shape[-2:]
    bad = np.abs(got["disp"] - want["disp"]) > 4e-3
    assert not bad[~tie_region[:, :H, :W]].any()
    assert bad.mean() < 0.10


def test_frozen_roundtrip(setup, artifact):
    *_, images, model = setup
    path, exported = artifact
    meta = load_meta(path)
    assert meta["magic"] == MAGIC and meta["divis_by"] == 8
    assert meta["device"] == "cpu" and meta["input_shape"] == list(SHAPE)
    assert meta["frozen_params"] and meta["op_namespace"] == "nmrf"
    # the artifact carries its own weights: called with images only
    _assert_equal(exported.module()(*_torch(images)), _live(model, images))


def test_hotswap_convention(setup, tmp_path):
    """An artifact of the (params, img1, img2) convention, exported from one
    set of weights, run with a second: equal (atol 0) to the live model
    with the second set."""
    _, params, _, images, model = setup
    exported = export_eval(model, SHAPE, freeze_params=False)
    path = str(tmp_path / "hotswap.pt2")
    save_exported(exported, path)
    assert not load_meta(path)["frozen_params"]
    other = _port_model(_noisy(params, 2))
    weights = {k: v.detach() for k, v in other.named_parameters()}
    with torch.no_grad():
        got = load_exported(path).module()(weights, *_torch(images))
    _assert_equal(got, _live(other, images))


def test_wrong_shape_rejected(artifact):
    module = artifact[1].module()
    bad = torch.zeros((1, 40, 64, 3))
    with pytest.raises(Exception):
        module(bad, bad)


def test_port_artifact_matches_jax_artifact(setup, artifact):
    model_jax, params, _, images, model = setup
    exp = export_jax.export_eval(model_jax, jax.tree_util.tree_map(
        jnp.asarray, params), SHAPE, platforms=("cpu",))
    want = exp.call(*(jnp.asarray(x) for x in images))
    with torch.no_grad():
        got = artifact[1].module()(*_torch(images))
    _assert_matches_jax({k: v.numpy() for k, v in got.items()},
                        {k: np.asarray(v) for k, v in want.items()},
                        model, images)


def test_http_serving_roundtrip(setup, artifact):
    """POST a 30 x 60 pair: the server pads it to the artifact's 32 x 64 by
    edge replication and unpads the disparity, equal to the live port's
    ``predict`` and, at the slice tolerances, to the JAX eval of the same
    padded pair."""
    _, params, apply, images, model = setup
    path, exported = artifact
    srv = HTTPServer(("127.0.0.1", 0), serve_http.make_handler(
        exported, load_meta(path)))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_port}"
        with urllib.request.urlopen(base + "/healthz") as r:
            assert load_meta(path) == json.loads(r.read())
        H, W = 30, 60
        a, b = (x[0, :H, :W] for x in images)
        buf = io.BytesIO()
        np.savez(buf, img1=a, img2=b)
        req = urllib.request.Request(base + "/disparity", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req) as r:
            timing = json.loads(r.headers["X-Timing-Ms"])
            disp = np.load(io.BytesIO(r.read()))
        assert sorted(timing) == ["device_plus_readback", "dispatch",
                                  "pad_h2d", "serialize"]
        assert disp.shape == (H, W) and disp.dtype == np.float32
        np.testing.assert_array_equal(disp, predict(model, a, b))

        padded = tuple(np.pad(x, ((0, 2), (0, 4), (0, 0)), mode="edge")[None]
                       for x in (a, b))
        want = apply(jax.tree_util.tree_map(jnp.asarray, params),
                     *(jnp.asarray(x) for x in padded))
        _assert_matches_jax({"disp": disp[None]},
                            {"disp": np.asarray(want["disp"])[:, :H, :W]},
                            model, padded)

        big = io.BytesIO()
        np.savez(big, img1=np.zeros((40, 64, 3), np.float32),
                 img2=np.zeros((40, 64, 3), np.float32))
        req = urllib.request.Request(base + "/disparity", data=big.getvalue(),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req)
        assert err.value.code == 400
        assert b"exceeds exported 32x64" in err.value.read()
    finally:
        srv.shutdown()
        srv.server_close()


def _op_cases(dtype):
    """(operator, plain version, CPU arguments) of each ``nmrf`` operator."""
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(1, 12, 18, 4, 96, generator=g).to(dtype)
    table = torch.randn(121, 96, generator=g)
    q, k, v = (torch.randn(1, 8, 6, 4, 32, generator=g).to(dtype)
               for _ in range(3))
    vmap = torch.randn(1, 3, 4, 16, generator=g).to(dtype)
    dx, dy, aw = (torch.rand(1, 6, 8, 8, generator=g) for _ in range(3))
    return [
        (A.window_attention_op,
         lambda *a: A.window_attention_plain(*a[:3], tuple(a[3]), *a[4:]),
         (qkv, table, 3, [6, 6], 2, True, 0, None)),
        (A.stripe_attention_op, A.stripe_attention_plain, (q, k, v, 8, 1, 2)),
        (msda.msda_taps_op, msda.msda_taps_plain, (vmap, dx, dy, aw, 2, 2)),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", [0, 1, 2],
                         ids=["window_attention", "stripe_attention", "msda_taps"])
def test_registered_op_on_meta_tensors(dtype, index):
    """The fake implementation gives the plain version's shape and dtype."""
    op, plain, args = _op_cases(dtype)[index]
    want = plain(*args)
    got = op(*(a.to("meta") if torch.is_tensor(a) else a for a in args))
    assert got.device.type == "meta"
    assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("index", [0, 1, 2],
                         ids=["window_attention", "stripe_attention", "msda_taps"])
def test_registered_op_raises_on_cpu_tensors(index):
    """No CPU implementation: only the wrappers take the plain versions."""
    op, _, args = _op_cases(torch.float32)[index]
    with pytest.raises(NotImplementedError, match="CPU"):
        op(*args)
