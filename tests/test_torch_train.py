"""The port's training slice against the JAX package (CPU, float32).

* (a) ``soft_histogram`` and (f) ``make_stereo_pair`` equal the JAX ones;
* (b) ``Criterion``: every loss term and ``total`` on identical output
  dicts, for L1 and SMOOTH_L1 and both proposal-weight settings (rtol 1e-6:
  the same f32 reductions in another order);
* (c) the optimizer: the parameters after each of 3 updates, and under
  ``ACCUM_STEPS 2``, equal the JAX ``build_optimizer``'s on identical
  gradients (rtol 1e-6), the schedule equals the JAX one, and every
  parameter's group is the JAX ``label_params`` label of its leaf, for the
  resnet and the swin variant;
* (d) one whole step at 64x128, batch 2, 2 layers per stage, on the same
  weights and batch: every loss term at rtol 1e-5, every gradient leaf at
  |d| <= 1e-4 max|g_jax| + 1e-6, with the JAX side on its XLA path and on
  its Pallas path (the backward kernels in interpret mode on the CPU);
* (e) ``TPU.REMAT`` leaves the gradients as they are (rtol 1e-5).
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nmrf_tpu.config import get_cfg as get_cfg_jax
from nmrf_tpu.data.synthetic import make_stereo_pair as make_stereo_pair_jax
from nmrf_tpu.models import build_model as build_model_jax
from nmrf_tpu.models.losses import Criterion as CriterionJax
from nmrf_tpu.ops.histogram import soft_histogram as soft_histogram_jax
from nmrf_tpu.solver.optimizer import GROUPS, label_params
from nmrf_tpu.solver.optimizer import build_optimizer as build_optimizer_jax
from nmrf_tpu.utils.checkpoint import convert_torch_state_dict
from nmrf_tpu_torch import (build_criterion, build_model, build_optimizer,
                            get_cfg, make_train_step)
from nmrf_tpu_torch.data import make_stereo_pair, synthetic_batch
from nmrf_tpu_torch.models.losses import Criterion
from nmrf_tpu_torch.ops.histogram import soft_histogram
from nmrf_tpu_torch.solver import param_group
from nmrf_tpu_torch.utils.convert import params_from_jax

H, W, B = 64, 128, 2
# Argmax ties and ReLU kinks flip gradients.  Near-equal candidate labels
# give near-equal proposal logits, so the score head's weights are scaled by
# LOGIT_SCALE, and the hidden ReLU layers of the three MLP heads get their
# biases raised by HEAD_BIAS, so that no hidden unit sits within the f32
# difference of the two packages (about 1e-6) of the kink.  The batch seed
# is one whose smallest top-2 margin of the final proposal logits is above
# MIN_MARGIN (asserted on the JAX run), well above that difference at
# logits of about 20 (about 2e-5).
LOGIT_SCALE = 300.0
HEAD_BIAS = 1.0
BATCH_SEED = 7
MIN_MARGIN = 1e-4


def _small(cfg, use_pallas=True, remat=False):
    cfg.NMP.NUM_PROP_LAYERS = 2
    cfg.NMP.NUM_INFER_LAYERS = 2
    cfg.NMP.NUM_REFINE_LAYERS = 2
    cfg.SOLVER.LOSS_WEIGHTS = [1.0, 1.2, 1.4, 2.0]
    cfg.TPU.USE_PALLAS = use_pallas
    cfg.TPU.REMAT = remat
    return cfg


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_params():
    """JAX init params plus seeded noise (so the zero-initialised tables,
    biases and the zero last layer of the DPN head are exercised)."""
    cfg = _small(get_cfg_jax())
    cfg.freeze()
    model, _ = build_model_jax(cfg)
    zeros = jnp.zeros((1, H, W, 3))
    params = jax.jit(lambda r: model.init(r, zeros, zeros, train=False))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rng.randn(*x.shape).astype(np.float32),
        dict(params))
    tree = params["params"]
    tree["infer_score_head"]["kernel"] *= LOGIT_SCALE
    for head in (tree["infer_head"], tree["refine_head"],
                 tree["dpn"]["prop_head"]):
        for layer in ("layers_0", "layers_1"):
            head[layer]["bias"] += HEAD_BIAS
    return params


@pytest.fixture(scope="module")
def batch():
    return synthetic_batch(B, H, W, max_disp=48, seed=BATCH_SEED)


def _port_model(params, remat=False):
    model = build_model(_small(get_cfg(), remat=remat), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _port_step_grads(model, batch):
    model.zero_grad(set_to_none=True)
    model.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = model(tb["img1"], tb["img2"])
    losses = build_criterion(_small(get_cfg()))(out, tb)
    losses["total"].backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return ({k: float(v.detach()) for k, v in losses.items()},
            convert_torch_state_dict(grads)[0])


# ---- (a), (f) ---- #

def test_soft_histogram_matches_jax():
    rng = np.random.RandomState(0)
    values = (rng.rand(50, 64) * 44 - 2).astype(np.float32)  # past both ends
    values[:, :3] = [0.0, 39.0, 39.5]
    weights = (rng.rand(50, 64) > 0.3).astype(np.float32)
    want = np.asarray(soft_histogram_jax(jnp.asarray(values),
                                         jnp.asarray(weights), 40))
    got = soft_histogram(torch.from_numpy(values), torch.from_numpy(weights),
                         40).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quantum", [1, 8])
def test_make_stereo_pair_matches_jax(quantum):
    a = make_stereo_pair(40, 96, 32, rng=np.random.RandomState(5),
                         disp_quantum=quantum)
    b = make_stereo_pair_jax(40, 96, 32, rng=np.random.RandomState(5),
                             disp_quantum=quantum)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ---- (b) ---- #

def _outputs(rng, L_i=2, L_r=2):
    hw, N, D = (H // 8) * (W // 8), 4, 40
    prob = rng.rand(B * hw, D).astype(np.float32)
    return {
        "proposal": (rng.rand(B, hw, N) * 8).astype(np.float32),
        "prob": prob / prob.sum(-1, keepdims=True),
        "disp": (rng.rand(B, H, W) * 60).astype(np.float32),
        "disp_pred": (rng.rand(B, H, W) * 15).astype(np.float32),
        "coarse_disp_layers": (rng.rand(L_i, B, H, W, N) * 8).astype(np.float32),
        "logits_layers": rng.randn(L_i, B, H, W, N).astype(np.float32),
        "disp_pred_layers": (rng.rand(L_r, B, H, W) * 15).astype(np.float32),
    }


@pytest.mark.parametrize("fix", [True, False])
@pytest.mark.parametrize("loss_type", ["L1", "SMOOTH_L1"])
def test_criterion_matches_jax(loss_type, fix):
    rng = np.random.RandomState(2)
    outputs = _outputs(rng)
    targets = {"disp": (rng.rand(B, H, W) * 400 - 20).astype(np.float32),
               "valid": rng.rand(B, H, W) > 0.2}
    kw = dict(max_disp=192, loss_type=loss_type, loss_weights=[1.0, 1.2, 1.4, 2.0],
              aux_loss=True, fix_proposal_weight=fix, num_infer_layers=2,
              num_refine_layers=2)
    want = CriterionJax(**kw)({k: jnp.asarray(v) for k, v in outputs.items()},
                              {k: jnp.asarray(v) for k, v in targets.items()})
    got = Criterion(**kw)({k: torch.from_numpy(v) for k, v in outputs.items()},
                          {k: torch.from_numpy(v) for k, v in targets.items()})
    assert set(got) == set(want)
    assert len(got) == 8  # prop, init, disp, epe, 2 coarse, 1 aux disp, total
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-6, err_msg=key)


# ---- (c) ---- #

class _Fixed(torch.nn.Module):
    def forward(self, img1, img2):
        return {}


def _opt_cfg(cfg, accum):
    cfg = _small(cfg)
    cfg.SOLVER.MAX_ITER = 100  # warm-up ends at update 9: lr moves each step
    cfg.SOLVER.WEIGHT_DECAY = 0.01
    cfg.SOLVER.WEIGHT_DECAY_NORM = 0.02
    cfg.SOLVER.ACCUM_STEPS = accum
    return cfg


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_matches_jax(jax_params, accum):
    micro_steps = 3 * accum
    rng = np.random.RandomState(4)
    grad_sets = [jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), jax_params)
        for _ in range(micro_steps)]

    cfg_j = _opt_cfg(get_cfg_jax(), accum)
    cfg_j.freeze()
    tx, _ = build_optimizer_jax(jax_params, cfg_j)
    params_j = jax.tree_util.tree_map(jnp.asarray, jax_params)
    state = tx.init(params_j)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))

    cfg = _opt_cfg(get_cfg(), accum)
    model = _port_model(jax_params)
    optimizer, scheduler = build_optimizer(model, cfg)
    named = dict(model.named_parameters())
    torch_grads = iter(params_from_jax(g) for g in grad_sets)

    def criterion(out, targets):
        g = next(torch_grads)
        return {"total": accum * sum((p * g[n]).sum() for n, p in named.items())}

    step = make_train_step(_Fixed(), criterion, optimizer, scheduler,
                           accum_steps=accum, grad_clip=cfg.SOLVER.GRAD_CLIP)
    for i in range(micro_steps):
        updates, state = update(jax.tree_util.tree_map(jnp.asarray, grad_sets[i]),
                                state, params_j)
        params_j = jax.tree_util.tree_map(lambda p, u: p + u, params_j, updates)
        step({k: None for k in ("img1", "img2", "disp", "valid")})
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j))
        got = model.state_dict()
        for key, value in want.items():
            # atol: where a clipped gradient (or a mean of two that nearly
            # cancel) is about Adam's eps, one f32 ulp of it in another
            # summation order moves m / (sqrt(v) + eps) by up to 1e-3, so
            # the update (lr about 2e-5 here) by up to about 3e-8
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{i} {key}")


@pytest.mark.parametrize("variant", ["resnet", "swin"])
def test_schedule_and_groups_match_jax(jax_params, variant):
    cfg_j = get_cfg_jax()
    _, schedule_j = build_optimizer_jax(jax_params, cfg_j)
    total = cfg_j.SOLVER.MAX_ITER + 100
    up_end = int(0.05 * total) - 1
    steps = (0, 1, up_end, total // 2, total - 1)
    # the port's scheduler on a default and an offset (lr x 0.1) group
    tiny = torch.nn.ModuleDict({"proj": torch.nn.Linear(1, 1),
                                "sampling_offsets": torch.nn.Linear(1, 1)})
    opt, scheduler = build_optimizer(tiny, get_cfg())
    names = [g["name"] for g in opt.param_groups]
    got = {}
    for step in range(total):
        if step in steps:
            got[step] = dict(zip(names, scheduler.get_last_lr()))
        opt.step()
        scheduler.step()
    for step in steps:
        # the JAX schedule is float32: atol is about one ulp at the peak lr
        np.testing.assert_allclose(got[step]["default"], float(schedule_j(step)),
                                   rtol=1e-6, atol=1e-10, err_msg=str(step))
        assert got[step]["offset"] == pytest.approx(
            0.1 * got[step]["default"], rel=1e-12), step

    if variant == "resnet":
        model = _port_model(jax_params)
    else:
        cfg = _small(get_cfg())
        cfg.merge_from_file(str(Path(__file__).resolve().parent.parent
                                / "configs" / "sceneflow_swint.yaml"))
        model = build_model(cfg, device="cpu")
    codes = {n: torch.full_like(p, float(GROUPS.index(param_group(n))))
             for n, p in model.named_parameters()}
    tree, unmatched = convert_torch_state_dict(codes)
    assert unmatched == []
    want = _leaves(label_params(tree))
    got = _leaves(tree)
    assert want.keys() == got.keys()
    for key, label in want.items():
        assert (got[key] == GROUPS.index(label)).all(), key
    groups = {param_group(n) for n in codes}
    if variant == "resnet":  # no sampling offsets, no swin backbone
        assert groups == {"default", "norm", "rpe"}
    else:
        assert groups == set(GROUPS)


# ---- (d), (e) ---- #

@pytest.fixture(scope="module")
def jax_step():
    """Losses, gradients and final proposal logits of the JAX step, on its
    XLA path and on its Pallas path."""

    def run(params, batch, use_pallas):
        cfg = _small(get_cfg_jax(), use_pallas)
        cfg.freeze()
        model, criterion = build_model_jax(cfg)

        def loss_fn(p):
            out = model.apply(p, batch["img1"], batch["img2"], train=True,
                              rngs={"dropout": jax.random.PRNGKey(0)})
            losses = criterion(out, {"disp": batch["disp"],
                                     "valid": batch["valid"]})
            return losses["total"], (losses, out["logits_layers"][-1])

        (_, (losses, logits)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
        return ({k: float(v) for k, v in losses.items()}, grads,
                np.asarray(logits))

    cache = {}

    def get(params, batch, use_pallas):
        if use_pallas not in cache:
            cache[use_pallas] = run(
                jax.tree_util.tree_map(jnp.asarray, params),
                {k: jnp.asarray(v) for k, v in batch.items()}, use_pallas)
        return cache[use_pallas]

    return get


@pytest.fixture(scope="module")
def port_step(jax_params, batch):
    return _port_step_grads(_port_model(jax_params), batch)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_step_matches_jax(jax_params, batch, jax_step, port_step,
                                use_pallas):
    want_losses, want_grads, logits = jax_step(jax_params, batch, use_pallas)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MIN_MARGIN
    got_losses, got_grads = port_step
    assert set(got_losses) == set(want_losses)
    for key, value in want_losses.items():
        np.testing.assert_allclose(got_losses[key], value, rtol=1e-5,
                                   err_msg=key)
    want, got = _leaves(want_grads), _leaves(got_grads)
    assert want.keys() == got.keys()
    bad = []
    for key, g in want.items():
        bound = 1e-4 * np.abs(g).max() + 1e-6
        err = np.abs(got[key] - g).max()
        if err > bound:
            bad.append(f"{key}: |d| {err:.3e} > {bound:.3e} (max {np.abs(g).max():.3e})")
    assert not bad, "\n".join(bad)


def test_remat_keeps_gradients(jax_params, batch, port_step):
    losses, grads = _port_step_grads(_port_model(jax_params, remat=True), batch)
    assert losses == pytest.approx(port_step[0], rel=1e-6)
    want, got = _leaves(port_step[1]), _leaves(grads)
    for key, g in want.items():
        np.testing.assert_allclose(got[key], g, rtol=1e-5, atol=1e-7,
                                   err_msg=key)


def test_train_step_lowers_loss_on_a_fixed_batch(jax_params, batch):
    """Two updates through ``make_train_step`` on one batch: finite losses
    and gradient norms, and the loss falls."""
    cfg = _small(get_cfg())
    cfg.SOLVER.BASE_LR = 5e-3
    cfg.SOLVER.MAX_ITER = 20
    model = _port_model(jax_params)
    optimizer, scheduler = build_optimizer(model, cfg)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                               grad_clip=cfg.SOLVER.GRAD_CLIP)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    totals = []
    for _ in range(3):
        losses = step(tb)
        assert all(torch.isfinite(v) for v in losses.values())
        totals.append(float(losses["total"]))
    assert totals[-1] < totals[0]
