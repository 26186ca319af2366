"""The port's H-sharded path against the JAX package (CPU, float32, gloo).

* each collective of ``nmrf_tpu_torch/parallel/spatial.py`` on 2 processes
  against its unsharded PyTorch equivalent, output and gradient (atol
  1e-5: the same sums in another order);
* the whole model at 96x64, batch 2, 2 layers per stage, DPN.MAX_DISP 64
  (each tile's h8 is 6 and h4 is 12) on a 1 x 2 grid (2 processes) and on a
  2 x 2 grid (4 processes, the data axis), identical weights through
  ``params_from_jax``:
  - eval outputs against the JAX ``spatial_sharded_apply`` on a (1, 2) CPU
    mesh and against the unsharded JAX model: prob, proposal, disp and
    disp_pred at atol 1e-4, initial_proposal exactly; on 2 x 2 also a
    batch of 1, replicated over the data axis;
  - train losses (|d| < 1e-4) and every gradient leaf against the JAX
    sharded step, at the tolerances of ``tests/test_spatial_model.py``:
    backbone leaves |d| / (max |g| over the backbone) < 1e-2, the others
    |d| / (max |g_leaf| + 1e-6) < 5e-3 (leaves whose exact gradient is zero:
    |d| / (max |g| over their layer) < 5e-3, see ``ZERO_GRAD_LEAVES``).

The processes run ``tests/test_torch_spatial_workers.py`` and import no JAX.
As in ``tests/test_torch_train.py``, the proposal logits are spread and the
MLP heads' hidden biases raised, so that no argmax near-tie or ReLU kink
flips a gradient between the two packages; the JAX run asserts the margin.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nmrf_tpu.config import get_cfg as get_cfg_jax
from nmrf_tpu.models import build_model as build_model_jax
from nmrf_tpu.parallel import make_mesh as make_mesh_jax
from nmrf_tpu.parallel import spatial_sharded_apply as spatial_apply_jax
from nmrf_tpu.utils.checkpoint import convert_torch_state_dict
from nmrf_tpu_torch.data import synthetic_batch
from nmrf_tpu_torch.parallel import spawn
from nmrf_tpu_torch.utils.convert import params_from_jax

from . import test_torch_spatial_workers as W

B, H, WIDTH = 2, 96, 64
LOGIT_SCALE = 300.0
HEAD_BIAS = 1.0
BATCH_SEED = 2
MIN_MARGIN = 1e-4
# Leaves whose gradient is zero in exact arithmetic: a key bias b adds q_i.b
# to every logit of row i of a softmax over keys, and the proposal score
# head's bias adds one value to every candidate's logit of a sub-pixel.  Both
# packages leave rounding noise there (about 1e-8), so, as the JAX test does
# for the backbone leaves an instance norm cancels, the error is normalised
# by the gradient scale of the leaf's layer (its kernel and bias).
ZERO_GRAD_LEAVES = ("['k']['bias']", "['infer_score_head']['bias']")


# ---- collectives ---- #

def _global_outputs(name, xg, world):
    """The unsharded equivalent: every tile's output from the global x."""
    Ht = W.TILE[1]

    def tiles(y):
        return [y[:, r * Ht:(r + 1) * Ht] for r in range(world)]

    if name == "roll_up":
        return tiles(torch.roll(xg, -3, 1))
    if name == "roll_down":
        return tiles(torch.roll(xg, 2, 1))
    if name == "halo":
        z = torch.zeros_like(xg[:, :1])
        p = torch.cat([z, xg, z], 1)
        return [p[:, r * Ht:r * Ht + Ht + 2] for r in range(world)]
    if name == "halo_wrap":
        p = torch.cat([xg[:, -2:], xg, xg[:, :2]], 1)
        return [p[:, r * Ht:r * Ht + Ht + 4] for r in range(world)]
    if name == "gather":
        return [xg] * world
    m = xg.mean(dim=(1, 2), keepdim=True)
    v = ((xg - m) ** 2).mean(dim=(1, 2), keepdim=True)
    return tiles((xg - m) * torch.rsqrt(v + 1e-5))


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives")
    spawn(W.collectives_worker, 2, "gloo", args=(str(out),), timeout_s=120)
    return [torch.load(out / f"collectives_{r}.pt") for r in range(2)]


@pytest.mark.parametrize("name", ["roll_up", "roll_down", "halo", "halo_wrap",
                                  "gather", "instance_norm"])
def test_collective_matches_unsharded(collectives, name):
    world = 2
    x, cot = W.collective_inputs(world)
    xg = torch.from_numpy(x).requires_grad_()
    outs = _global_outputs(name, xg, world)
    Ht = W.TILE[1]
    per_rank = name in ("halo", "halo_wrap", "gather")  # [world, ...]
    cots = [torch.from_numpy(cot[name][r] if per_rank
                             else cot[name][:, r * Ht:(r + 1) * Ht])
            for r in range(world)]
    sum((o * c).sum() for o, c in zip(outs, cots)).backward()
    for r in range(world):
        got_out, got_grad = collectives[r][name]
        torch.testing.assert_close(got_out, outs[r].detach(), atol=1e-5,
                                   rtol=1e-5)
        torch.testing.assert_close(got_grad, xg.grad[:, r * Ht:(r + 1) * Ht],
                                   atol=1e-5, rtol=1e-5)


# ---- the whole model ---- #

def _jax_cfg():
    cfg = get_cfg_jax()
    cfg.NMP.NUM_PROP_LAYERS = 2
    cfg.NMP.NUM_INFER_LAYERS = 2
    cfg.NMP.NUM_REFINE_LAYERS = 2
    cfg.SOLVER.LOSS_WEIGHTS = [1.0, 1.2, 1.4, 2.0]
    cfg.DPN.MAX_DISP = 64
    cfg.SOLVER.MAX_DISP = 48
    cfg.freeze()
    return cfg


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_weights_and_batch(model):
    """The test weights (flax tree as numpy: the JAX init, a seeded jitter,
    the proposal logits spread and the MLP heads' hidden biases raised) and
    the synthetic batch."""
    zeros = jnp.zeros((1, H, WIDTH, 3))
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
    return params, synthetic_batch(B, H, WIDTH, max_disp=48, seed=BATCH_SEED)


def jax_sharded_step(cfg, params, batch):
    """Losses and gradient leaves of one JAX training step on a (1, 2) CPU
    mesh (``spatial_sharded_apply``); asserts the proposal-logit margin."""
    _, criterion = build_model_jax(cfg)
    model_sp, _ = build_model_jax(cfg, spatial_axis="spatial")
    p = jax.tree_util.tree_map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = make_mesh_jax(1, 2, devices=jax.devices()[:2])

    def loss_fn(p):
        out = spatial_apply_jax(model_sp, mesh, p, jb["img1"], jb["img2"],
                                train=True)
        losses = criterion(out, {"disp": jb["disp"], "valid": jb["valid"]})
        return losses["total"], (losses, out["logits_layers"][-1])

    (_, (losses, logits)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(p)
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MIN_MARGIN
    return {k: float(v) for k, v in losses.items()}, _leaves(grads)


@pytest.fixture(scope="module")
def jax_side():
    """Weights, batch, and the JAX package's outputs: the sharded (1, 2)
    forward, the unsharded forward, and the sharded train losses and
    gradients."""
    cfg = _jax_cfg()
    model, _ = build_model_jax(cfg)
    model_sp, _ = build_model_jax(cfg, spatial_axis="spatial")
    params, batch = jax_weights_and_batch(model)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = make_mesh_jax(1, 2, devices=jax.devices()[:2])

    sharded = jax.jit(lambda p, a, b: spatial_apply_jax(
        model_sp, mesh, p, a, b, train=False))(p, jb["img1"], jb["img2"])
    unsharded = jax.jit(lambda p, a, b: model.apply(p, a, b, train=False))(
        p, jb["img1"], jb["img2"])
    losses, grads = jax_sharded_step(cfg, params, batch)
    np_out = (lambda o: {k: np.asarray(v) for k, v in o.items()})
    return {"params": params, "batch": batch, "sharded": np_out(sharded),
            "unsharded": np_out(unsharded), "losses": losses, "grads": grads}


@pytest.fixture(scope="module")
def port_runs(jax_side, tmp_path_factory):
    """{"1x2": rank results, "2x2": rank results} of the sharded port."""
    inputs = tmp_path_factory.mktemp("spatial_in")
    torch.save(params_from_jax(jax_side["params"]), inputs / "weights.pt")
    np.savez(inputs / "batch.npz", **jax_side["batch"])
    runs = {}
    for data, spatial in ((1, 2), (2, 2)):
        out = tmp_path_factory.mktemp(f"spatial_{data}x{spatial}")
        spawn(W.model_worker, data * spatial, "gloo",
              args=(data, spatial, str(inputs), str(out)), timeout_s=180)
        runs[f"{data}x{spatial}"] = [torch.load(out / f"model_{r}.pt")
                                     for r in range(data * spatial)]
    return runs


GRIDS = ["1x2", "2x2"]


def _check_eval(got, want):
    for key in ("prob", "proposal", "disp", "disp_pred"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-4,
                                   rtol=0, err_msg=key)
    np.testing.assert_array_equal(got["initial_proposal"].numpy(),
                                  want["initial_proposal"])


@pytest.mark.parametrize("grid", GRIDS)
def test_eval_matches_jax_sharded(jax_side, port_runs, grid):
    ranks = port_runs[grid]
    _check_eval(ranks[0]["eval"], jax_side["sharded"])
    for other in ranks[1:]:  # every rank holds the same global outputs
        for key, value in ranks[0]["eval"].items():
            torch.testing.assert_close(other["eval"][key], value, atol=0, rtol=0)


@pytest.mark.parametrize("grid", GRIDS)
def test_eval_matches_jax_unsharded(jax_side, port_runs, grid):
    _check_eval(port_runs[grid][0]["eval"], jax_side["unsharded"])


def test_batch1_eval_replicates_over_data_axis(port_runs):
    """A batch of 1 on the 2 x 2 grid (it does not divide over the data
    axis): every data index runs the pair, the spatial axis shares it; the
    outputs equal the first pair's of the batch of 2."""
    ranks = port_runs["2x2"]
    full = ranks[0]["eval"]
    for rank in ranks:
        b1 = rank["eval_b1"]
        for key, value in b1.items():  # the first rows are the first pair's
            torch.testing.assert_close(value, full[key][:value.shape[0]],
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("grid", GRIDS)
def test_train_losses_and_gradients_match_jax_sharded(jax_side, port_runs, grid):
    check_train_step(port_runs[grid], jax_side["losses"], jax_side["grads"])


def check_train_step(ranks, want_losses, want):
    """The port's sharded step (rank results) against the JAX step's losses
    (|d| < 1e-4) and gradient leaves (the tolerances of
    ``tests/test_spatial_model.py``); every rank holds the same summed
    gradients."""
    rank0 = ranks[0]
    assert set(rank0["losses"]) == set(want_losses)
    for key, value in want_losses.items():
        assert abs(rank0["losses"][key] - value) < 1e-4, (key, rank0["losses"][key], value)
    got = _leaves(convert_torch_state_dict(rank0["grads"])[0])
    assert got.keys() == want.keys()
    bb_scale = max(np.abs(g).max() for k, g in want.items() if "backbone" in k)
    bad = []
    for key, g in want.items():
        if "backbone" in key:
            err = np.abs(got[key] - g).max() / bb_scale
            ok = err < 1e-2
        elif key.endswith(ZERO_GRAD_LEAVES):
            scope = key[:key.rindex("['")]  # the layer: kernel and bias
            scale = max(np.abs(v).max() for k, v in want.items()
                        if k.startswith(scope))
            err = np.abs(got[key] - g).max() / (scale + 1e-6)
            ok = err < 5e-3
        else:
            err = np.abs(got[key] - g).max() / (np.abs(g).max() + 1e-6)
            ok = err < 5e-3
        if not ok:
            bad.append(f"{key}: {err:.3e}")
    assert not bad, "\n".join(bad)
    for other in ranks[1:]:  # the summed gradients agree everywhere
        for key, value in rank0["grads"].items():
            torch.testing.assert_close(other["grads"][key], value, atol=0, rtol=0)
