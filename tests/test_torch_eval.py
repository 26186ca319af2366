"""The port's evaluation against the JAX package (CPU).

* ``DispEvaluator``: the metrics of the same arrays equal the JAX ones to
  1e-12, with and without the proposal metrics (superpixels given, or made
  from the left image), and ``print_csv_format`` logs the same lines;
* ``utils.dist``: float64 lists of different lengths gathered exactly over
  two gloo processes, and the metrics of an ``InferenceSampler``-sharded
  evaluation equal the one-process metrics;
* ``train.evaluate`` end to end on ``synthetic_1x50x70`` (the padder and the
  eval bucket both pad) with the JAX weights carried by
  ``params_from_jax``, against root ``train.evaluate``: prob and proposals
  strict, the disparity tie-aware (``tests/test_fullmodel_parity.py:
  163-182``), ``epe`` and ``prop_*`` to 1e-3 relative.
"""

import logging

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from nmrf_tpu.config import get_cfg as get_cfg_jax
from nmrf_tpu.data.superpixel import slic_segments
from nmrf_tpu.evalx import DispEvaluator as DispEvaluatorJax
from nmrf_tpu.evalx import print_csv_format as print_csv_jax
from nmrf_tpu.models import build_model as build_model_jax
from nmrf_tpu_torch import build_model, get_cfg
from nmrf_tpu_torch.evalx import DispEvaluator, print_csv_format
from nmrf_tpu_torch.parallel import make_eval_step, spawn
from nmrf_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_spatial_workers import eval_frames, gather_worker


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (the suite runs a test process per core or so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("eval_prop,labels,only_valid", [
    (False, False, True), (True, False, True), (True, True, False)])
def test_evaluator_matches_jax(eval_prop, labels, only_valid, caplog):
    kw = dict(thres=["1.0", "3.0"], only_valid=only_valid, max_disp=48,
              eval_prop=eval_prop, divis_by=8)
    got, want = DispEvaluator(**kw), DispEvaluatorJax(**kw)
    inputs, outputs = eval_frames(n=4, H=37, W=50)
    for i, o in zip(inputs, outputs):
        o = dict(o, proposal=np.random.RandomState(1).rand(1, 5 * 7, 4)
                 .astype(np.float32) * 6)
        if labels:
            i = dict(i, super_pixel_label=slic_segments(i["img1"][0])[None])
        got.process(i, o)
        want.process(i, o)
    a, b = got.evaluate()["disp"], want.evaluate()["disp"]
    assert a.keys() == b.keys() and ("prop_epe" in a) == eval_prop
    for key in a:
        assert a[key] == pytest.approx(b[key], rel=1e-12, abs=1e-12), key

    lines = []
    for fn, name in ((print_csv_format, "port"), (print_csv_jax, "jax")):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            fn({"disp": a}, logging.getLogger(f"test_eval.{name}"))
        lines.append([r.getMessage() for r in caplog.records])
    assert lines[0] == lines[1] and len(lines[0]) == 3


def test_metrics_gather_over_two_processes(tmp_path):
    spawn(gather_worker, 2, args=(str(tmp_path),))
    values = [[1.0 + (r + 1) * 1e-12 * (i + 1) for i in range(r + 2)]
              for r in range(2)]
    whole = DispEvaluator(thres=["1.0", "3.0"], only_valid=True, max_disp=64,
                          eval_prop=True)
    for i, o in zip(*eval_frames()):
        whole.process(i, o)
    want = whole.evaluate()["disp"]
    for rank in range(2):
        out = torch.load(tmp_path / f"gather_{rank}.pt", weights_only=True)
        assert out["gathered"] == values and out["empty"] == [[], []]
        got = out["metrics"]["disp"]
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-12), key


H, W = 48, 96  # the weights' init shape; the eval set is 50x70


def _small(cfg):
    cfg.NMP.NUM_PROP_LAYERS = 2
    cfg.NMP.NUM_INFER_LAYERS = 2
    cfg.NMP.NUM_REFINE_LAYERS = 2
    cfg.DPN.MAX_DISP = 64
    cfg.DATASETS.TEST = ["synthetic_1x50x70"]
    cfg.TEST.EVAL_THRESH = [["1.0", "3.0"]]
    cfg.TEST.EVAL_MAX_DISP = [64]
    cfg.TEST.EVAL_ONLY_VALID = [True]
    cfg.TEST.EVAL_PROP = [True]
    cfg.TPU.EVAL_BUCKET = 32
    cfg.freeze()
    return cfg


def test_evaluate_matches_root_train_evaluate():
    import train as train_jax

    from nmrf_tpu_torch import train as train_port

    cfg_jax = _small(get_cfg_jax())
    model_jax, _ = build_model_jax(cfg_jax)
    zeros = jnp.zeros((1, H, W, 3))
    params = jax.jit(lambda r: model_jax.init(r, zeros, zeros, train=False))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rng.randn(*x.shape).astype(np.float32),
        dict(params))

    seen = {"jax": [], "port": []}
    apply = jax.jit(lambda p, a, b: model_jax.apply(p, a, b, train=False))

    def eval_step_jax(p, a, b):
        seen["jax"].append((np.asarray(a), np.asarray(b)))
        out = apply(p, a, b)
        seen["jax"].append({k: np.asarray(v) for k, v in out.items()})
        return out

    model = build_model(_small(get_cfg()), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    step = make_eval_step(model)

    def eval_step_port(a, b):
        out = step(a, b)
        seen["port"].append({k: v.float().numpy() for k, v in out.items()})
        return out

    logger = logging.getLogger("test_eval")
    want = train_jax.evaluate(eval_step_jax, jax.tree_util.tree_map(jnp.asarray, params),
                              cfg_jax, logger)["disp"]
    got = train_port.evaluate(eval_step_port, _small(get_cfg()), logger,
                              torch.device("cpu"))["disp"]

    (a, b), ref = seen["jax"]
    assert a.shape == (1, 64, 96, 3)  # 50x70 -> 56x72 (padder) -> 64x96
    out = seen["port"][0]
    np.testing.assert_allclose(out["prob"], ref["prob"], atol=2e-4, rtol=1e-3)
    for key in ("initial_proposal", "proposal"):
        np.testing.assert_allclose(out[key], ref[key], atol=1e-3, rtol=0)
    logits = np.asarray(jax.jit(lambda p, x, y: model_jax.apply(
        p, x, y, train=True, rngs={"dropout": jax.random.PRNGKey(0)}))(
        jax.tree_util.tree_map(jnp.asarray, params), a, b)["logits_layers"][-1])
    top2 = np.sort(logits, axis=-1)[..., -2:]
    near_tie = torch.from_numpy((top2[..., 1] - top2[..., 0] < 1e-5).astype(np.float32))
    tie_region = (F.max_pool2d(near_tie[:, None], 193, 1, 96)[:, 0] > 0).numpy()
    bad = np.abs(out["disp"] - ref["disp"]) > 4e-3
    assert not bad[~tie_region].any() and bad.mean() < 0.10

    assert got.keys() == want.keys() and "prop_epe" in got
    for key in ("epe", "prop_epe", "prop_recall_3", "prop_recall_8"):
        assert got[key] == pytest.approx(want[key], rel=1e-3), key
