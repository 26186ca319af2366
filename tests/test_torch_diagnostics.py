"""The convergence-gate diagnostics of the port against the JAX package's
(CPU, float32): ``nmrf_tpu_torch/tools/probe_costvolume_signal.py`` and
``nmrf_tpu_torch/tools/debug_convergence.py`` against the root
``tools/probe_costvolume_signal.py`` and ``tools/debug_convergence.py``.

Both packages start from the JAX package's init of the default model at one
layer a stage (``params_from_jax``), at 64 x 128:

* the probe's pairs are the JAX tool's (its ``aligned_pair`` and
  ``make_stereo_pair`` on ``RandomState(100 + s)``), and its exact-bin and
  within-1-bin accuracies equal those of the argmax of the JAX
  ``extract_feature`` and ``correlation_volume``, summed over the groups:
  exactly where no argmax flips, and a flip only where the JAX volume's
  two bins are within 1e-4 of its spread (a tie in f32);
* ``prediction_stats`` equals the JAX tool's formulas (``eval_stats``,
  transcribed here: the tool's lines are not a function) on the same
  outputs at 1e-5;
* three steps of the overfit probe (``overfit_probe``, the tool's loop) on
  its fixed batch give the losses of three JAX steps
  (``nmrf_tpu.parallel.make_train_step`` with ``build_optimizer``'s AdamW
  and OneCycle over the same 3 steps) at rtol 1e-4, and its printed lines
  parse.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrf_tpu.config import get_cfg as get_cfg_jax
from nmrf_tpu.data.synthetic import make_stereo_pair as make_stereo_pair_jax
from nmrf_tpu.models import build_model as build_model_jax
from nmrf_tpu.ops.correlation import correlation_volume as correlation_jax
from nmrf_tpu.parallel import make_train_step as make_train_step_jax
from nmrf_tpu.solver import build_optimizer as build_optimizer_jax
from nmrf_tpu_torch import build_model, get_cfg
from nmrf_tpu_torch.tools import debug_convergence as D
from nmrf_tpu_torch.tools import probe_costvolume_signal as P
from nmrf_tpu_torch.tools.convergence_gate import make_batch
from nmrf_tpu_torch.utils.convert import params_from_jax
from tools.probe_costvolume_signal import aligned_pair as aligned_pair_jax

from .test_torch_swin_train import few_threads  # noqa: F401

H, W = 64, 128
STEPS = 3


def _small(cfg):
    cfg.NMP.NUM_PROP_LAYERS = 1
    cfg.NMP.NUM_INFER_LAYERS = 1
    cfg.NMP.NUM_REFINE_LAYERS = 1
    cfg.SOLVER.LOSS_WEIGHTS = [1.0, 2.0]
    cfg.DPN.MAX_DISP = 64
    cfg.SOLVER.MAX_DISP = 48
    cfg.DATASETS.CROP_SIZE = (H, W)
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.SOLVER.MAX_ITER = STEPS
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def jax_model():
    cfg = _small(get_cfg_jax())
    model, criterion = build_model_jax(cfg)
    zeros = jnp.zeros((1, H, W, 3))
    params = jax.jit(lambda r: model.init(r, zeros, zeros, train=False))(
        jax.random.PRNGKey(0))
    return cfg, model, criterion, params


def _port(params):
    model = build_model(_small(get_cfg()), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def test_probe_pairs_are_the_jax_tools():
    for kind, jax_pair in (("aligned8", lambda rng: aligned_pair_jax(
            H, W, 48, rng)), ("unaligned", lambda rng: make_stereo_pair_jax(
                H, W, max_disp=48, rng=rng))):
        for s, pair in enumerate(P.probe_pairs(kind, H, W, seeds=2)):
            want = jax_pair(np.random.RandomState(100 + s))
            for a, b in zip(pair, want):
                np.testing.assert_array_equal(a, b)


def test_probe_accuracies_match_jax(jax_model):
    _, model_j, _, params = jax_model

    @jax.jit
    def volume(img1, img2):
        f1, f2 = model_j.apply(params, img1, img2,
                               method=model_j.extract_feature)
        cv = correlation_jax(f1[0], f2[0], model_j.max_disp // 8,
                             model_j.cost_group)
        return cv.astype(jnp.float32).sum(3)

    model = _port(params)
    for kind in P.KINDS:
        pairs = P.probe_pairs(kind, H, W, seeds=2)
        got = P.cost_argmax_accuracy(model, pairs)
        hits, flips = [[], []], 0
        for img1, img2, disp, valid in pairs:
            cv = np.asarray(volume(jnp.asarray(img1)[None],
                                   jnp.asarray(img2)[None]))[0]
            top1 = P.cost_volume_argmax(model, torch.from_numpy(img1[None]),
                                        torch.from_numpy(img2[None]))[0].numpy()
            want_top1 = cv.argmax(-1)
            moved = top1 != want_top1
            if moved.any():  # a flip only between bins the JAX volume ties
                pick = np.take_along_axis(cv, top1[..., None], -1)[..., 0]
                gap = (cv.max(-1) - pick)[moved]
                assert (gap <= 1e-4 * np.ptp(cv)).all(), gap.max()
                flips += int(moved.sum())
            err = np.abs(want_top1 - disp[3::8, 3::8] / 8.0)[valid[3::8, 3::8]]
            hits[0].append((err <= 0.5).mean())
            hits[1].append((err <= 1.5).mean())
        want = (float(np.mean(hits[0])), float(np.mean(hits[1])))
        if flips == 0:
            assert got == want, (kind, got, want)
        else:
            np.testing.assert_allclose(got, want, atol=flips / 64)
        assert 0.0 <= got[1] <= 1.0 and got[0] <= got[1]


def _jax_eval_stats(out, gt, vd):
    """``tools/debug_convergence.py:eval_stats``'s numbers, as that tool
    computes them."""
    d = np.asarray(out["disp"])[0]
    res = [d[vd].mean(), d[vd].std(), d.min(), d.max(), np.abs(d - gt)[vd].mean()]
    g8 = gt[3::8, 3::8] / 8.0
    v8 = vd[3::8, 3::8]
    for key in ("initial_proposal", "proposal"):
        p = np.asarray(out[key])[0]
        h8, w8 = g8.shape
        p = p.reshape(h8, w8, -1)
        best = np.min(np.abs(p - g8[..., None]), axis=-1)
        res += [best[v8].mean(), p.mean(), p.max()]
    return res


def test_prediction_stats_match_the_jax_tools_formulas():
    rng = np.random.RandomState(0)
    gt = (rng.rand(H, W) * 48).astype(np.float32)
    vd = rng.rand(H, W) > 0.2
    out = {"disp": torch.from_numpy((rng.rand(1, H, W) * 60).astype(np.float32)),
           "initial_proposal": torch.from_numpy(
               (rng.rand(1, H * W // 64, 4) * 8).astype(np.float32)),
           "proposal": torch.from_numpy(
               (rng.rand(1, H * W // 64, 4) * 8).astype(np.float32))}
    got = D.prediction_stats(out, gt, vd)
    want = _jax_eval_stats({k: v.numpy() for k, v in out.items()}, gt, vd)
    keys = ["mean", "std", "min", "max", "epe"] + [
        f"{k}_{s}" for k in D.PROPOSAL_KEYS for s in ("bestEPE", "mean", "max")]
    np.testing.assert_allclose([got[k] for k in keys], want, rtol=1e-5,
                               atol=1e-5)
    line = D.stats_line("overfit", 50, got)
    assert re.fullmatch(r"\[overfit 50\] disp: mean [\d.]+ std [\d.]+ min [\d.]+ "
                        r"max [\d.]+ EPE [\d.]+  initial_proposal_bestEPE [\d.]+ "
                        r"initial_proposal\[mean [\d.]+ max [\d.]+\]  "
                        r"proposal_bestEPE [\d.]+ proposal\[mean [\d.]+ "
                        r"max [\d.]+\]", line), line


def test_overfit_steps_match_jax(jax_model):
    cfg_j, model_j, criterion_j, params = jax_model
    port_cfg = _small(get_cfg())
    lines = []
    result = D.overfit_probe(_port(params), port_cfg, STEPS, 48, 8, True,
                             log=lines.append)

    tx, _ = build_optimizer_jax(params, cfg_j)
    opt_state = tx.init(params)
    step = make_train_step_jax(model_j, criterion_j, tx, seed=cfg_j.SEED)
    batch = {k: jnp.asarray(v) for k, v in make_batch(port_cfg, 1, 48).items()}
    want = []
    for s in range(1, STEPS + 1):
        params, opt_state, losses = step(params, opt_state, batch, s)
        want.append({k: float(v) for k, v in losses.items()})
    assert len(result["history"]) == STEPS
    for got, ref in zip(result["history"], want):
        assert set(ref) <= set(got)
        for key, value in ref.items():
            np.testing.assert_allclose(got[key], value, rtol=1e-4, err_msg=key)
    assert want[-1]["total"] < want[0]["total"]

    assert re.fullmatch(r"GT disp stats: mean [\d.]+ std [\d.]+ max [\d.]+",
                        lines[0])
    assert lines[1].startswith("[init 0] disp: mean ")
    assert re.fullmatch(r"step 3: lr [\d.e+-]+ \{.*'total': [\d.]+.*\}", lines[2])
    assert lines[3].startswith("[overfit 3] disp: mean ")
    assert re.fullmatch(r"avg \d+ ms/step", lines[4])
    assert [s[:2] for s in result["stats"]] == [("init", 0), ("overfit", 3)]
