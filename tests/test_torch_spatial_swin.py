"""The swin model on the spatial axis against the JAX package (CPU,
float32, gloo).

The swin test config of ``tests/test_torch_swin_train.py`` (Swin-T, the
deformable neck with tap radius 5, drop-path 0.4, 2 layers per NMP stage)
at 96 x 64, batch 2, so that each of two H tiles holds whole windows (6
rows at 1/8: one Inference window; 12 at 1/4: three Refinement windows),
runs on a 1 x 2 grid (2 processes) and a 2 x 2 grid (4 processes, the data
axis), the weights through ``params_from_jax``.  The swin backbone runs on
the whole images of each data shard on every rank of a spatial group and
the decode on the rank's H tile (``nmrf_tpu_torch/parallel/mesh.py``).

The golden is the JAX package's unsharded swin forward and step:
``tests/test_spatial_model.py:149-215`` shows the JAX sharded swin forward
equal to the unsharded one (the JAX ``spatial_sharded_apply`` of a swin
model is a slow test, so it is not run here).

* eval: the gathered outputs against the JAX forward, prob and proposal
  at atol 1e-4, initial_proposal exactly, and disparity tie-aware as
  ``tests/test_spatial_model.py:191-215`` holds it (a winner may flip only
  where the two top logits are within 1e-5 of each other, times the
  test weights' logit spread ``LOGIT_SCALE``; strict 1e-4 where none
  flips);
* one training step with drop-path on (the JAX step's global masks
  replayed through ``DropPathMasks.draw_global``, as
  ``tests/test_torch_swin_mesh.py`` does): losses at rtol 1e-5, the
  world-summed gradients at the tolerances of
  ``tests/test_torch_spatial.py``, the same on every rank;
* ``msda_tap_oob`` equal on every rank and to the JAX value, at init (0)
  and with the second pair's samples moved beyond the tap radius (the
  data shards' shares averaged over the world: each spatial group holds
  its shard's backbone alike, so the world mean is the mean over the
  shards);
* the model's own drop-path masks: the same bits on every spatial rank of
  a data index, and that index's rows of one global draw.

The process body is ``swin_spatial_worker`` in
``tests/test_torch_spatial_workers.py``.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmrf_tpu.config import get_cfg as get_cfg_jax
from nmrf_tpu.models import build_model as build_model_jax
from nmrf_tpu_torch import get_cfg
from nmrf_tpu_torch.data import synthetic_batch
from nmrf_tpu_torch.models.layers import DropPathMasks
from nmrf_tpu_torch.parallel import spawn
from nmrf_tpu_torch.utils.convert import params_from_jax

from . import test_torch_spatial_workers as W
from .test_torch_spatial import check_train_step
from .test_torch_swin_mesh import jax_pushed_oob
from .test_torch_swin_train import (LOGIT_SCALE, MASK_SEED,  # noqa: F401
                                    RADIUS, KeepMasks, few_threads,
                                    jax_swin_step, leaves, swin_cfg,
                                    swin_params)

B, H, WIDTH = 2, 96, 64
BATCH_SEED = 5
GRIDS = [(1, 2), (2, 2)]
# a top-2 logit margin of noise: the JAX test's 1e-5, times the spread the
# test weights give the proposal logits (up to about 340 here)
TIE = 1e-5 * LOGIT_SCALE
ZERO_GRAD_LEAF = "['params']['dpn']['mlp_4']['bias']"


def batch():
    """synthetic_batch with a seeded dither of under one grey level, as
    ``tests/test_torch_swin_train.py:dithered_batch``."""
    out = synthetic_batch(B, H, WIDTH, max_disp=48, seed=BATCH_SEED)
    rng = np.random.RandomState(BATCH_SEED)
    for key in ("img1", "img2"):
        out[key] = out[key] + rng.rand(*out[key].shape).astype(np.float32)
    return out


def jax_eval(params, b):
    """The JAX unsharded eval forward and its final proposal logits."""
    cfg = swin_cfg(get_cfg_jax())
    cfg.freeze()
    model, _ = build_model_jax(cfg, msda_tap_radius=RADIUS)

    def fwd(p, a, c):
        return model.apply(p, a, c, train=False, mutable=["intermediates"],
                           capture_intermediates=lambda mdl, _: mdl.name == "infer_score_head")

    out, mvars = jax.jit(fwd)(jax.tree_util.tree_map(jnp.asarray, params),
                              jnp.asarray(b["img1"]), jnp.asarray(b["img2"]))
    logits = [v for k, v in leaves(mvars["intermediates"]).items()
              if "infer_score_head" in k]
    assert len(logits) == 1
    return {k: np.asarray(v) for k, v in out.items()}, logits[0][-1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX step, eval forward and pushed metric, and each grid's ranks'
    results; the grids' processes run while the JAX side computes the
    forwards that follow its step (the step draws the masks they replay)."""
    params, b, masks = swin_params(), batch(), KeepMasks(MASK_SEED)
    want = jax_swin_step(params, b, masks)
    tmp = tmp_path_factory.mktemp("swin_spatial")
    torch.save(params_from_jax(params), tmp / "weights.pt")
    np.savez(tmp / "batch.npz", **b)
    torch.save([(keep, torch.from_numpy(m)) for keep, m in masks.masks],
               tmp / "masks.pt")
    for data, spatial in GRIDS:
        (tmp / f"{data}x{spatial}").mkdir()
    with ThreadPoolExecutor(len(GRIDS)) as pool:
        grids = [pool.submit(spawn, W.swin_spatial_worker, data * spatial,
                             "gloo", args=(data, spatial, str(tmp),
                                           str(tmp / f"{data}x{spatial}")),
                             timeout_s=300) for data, spatial in GRIDS]
        want["pushed_oob"] = jax_pushed_oob(params, b, masks)
        want["eval"], want["eval_logits"] = jax_eval(params, b)
        for grid in grids:
            grid.result()
    ranks = {(data, spatial): [
        torch.load(tmp / f"{data}x{spatial}" / f"swin_spatial_{r}.pt")
        for r in range(data * spatial)] for data, spatial in GRIDS}
    return want, masks, ranks


def full_res(tiles, data, spatial):
    """The ranks' tiles of [b, h8, w8, N, 64] proposal logits (rank r: data
    index r // spatial, tile r % spatial) -> global [B, H, W, N]."""
    rows = [torch.cat(tiles[d * spatial:(d + 1) * spatial], dim=1)
            for d in range(data)]
    lg = torch.cat(rows, dim=0)
    b, h8, w8, n, _ = lg.shape
    lg = lg.reshape(b, h8, w8, n, 8, 8).permute(0, 1, 4, 2, 5, 3)
    return lg.reshape(b, h8 * 8, w8 * 8, n).numpy()


@pytest.mark.parametrize("grid", GRIDS)
def test_eval_matches_jax_forward(runs, grid):
    want, _, all_ranks = runs
    ranks = all_ranks[grid]
    got, ref = ranks[0]["eval"], want["eval"]
    for r in ranks[1:]:  # every rank holds the same global outputs
        for key, value in got.items():
            assert torch.equal(r["eval"][key], value), key
    for key in ("prob", "proposal"):
        np.testing.assert_allclose(got[key].numpy(), ref[key], atol=1e-4,
                                   rtol=0, err_msg=key)
    np.testing.assert_array_equal(got["initial_proposal"].numpy(),
                                  ref["initial_proposal"])
    # disparity, tie-aware: a winner may flip only on a noise-level margin
    rl = want["eval_logits"]
    b, h8, w8, n, _ = rl.shape
    rl = rl.reshape(b, h8, w8, n, 8, 8).transpose(0, 1, 4, 2, 5, 3).reshape(
        b, h8 * 8, w8 * 8, n)
    gl = full_res([r["eval_logits"] for r in ranks], *grid)
    flips = rl.argmax(-1) != gl.argmax(-1)
    if flips.any():
        srt = np.sort(rl, axis=-1)
        assert (srt[..., -1] - srt[..., -2])[flips].max() < TIE
        assert flips.mean() < 1e-3
    for key in ("disp", "disp_pred"):
        err = np.abs(got[key].numpy() - ref[key])
        if not flips.any():
            assert err.max() < 1e-4, (key, err.max())
        else:
            assert err.max() < 0.1 and (err > 1e-4).mean() < 0.01, key


@pytest.mark.parametrize("grid", GRIDS)
def test_training_step_matches_jax_step(runs, grid):
    want, masks, all_ranks = runs
    ranks = all_ranks[grid]
    # every rank replayed each of the JAX step's global draws once
    assert all(r["draws"] == len(masks.masks) == 22 for r in ranks)
    np.testing.assert_array_equal(
        full_res([r["step"]["logits"] for r in ranks], *grid).argmax(-1),
        want["logits"].argmax(-1))
    for r in ranks:
        for key, value in want["losses"].items():
            np.testing.assert_allclose(r["step"]["losses"][key], value,
                                       rtol=1e-5, err_msg=key)
    # the cost filter's last bias adds one value to all D logits of the
    # softmax: its exact gradient is 0 and both packages leave rounding
    # noise (2e-7 here), so it is held at its layer's scale, as
    # ``tests/test_torch_spatial.py:ZERO_GRAD_LEAVES`` holds such leaves
    want_grads = leaves(want["grads"])
    zero = want_grads.pop(ZERO_GRAD_LEAF)
    check_train_step(
        [{"losses": {k: r["step"]["losses"][k] for k in want["losses"]},
          "grads": {k: g for k, g in r["step"]["grads"].items()
                    if k != "dpn.mlp.4.bias"}} for r in ranks],
        want["losses"], want_grads)
    scale = np.abs(want_grads[ZERO_GRAD_LEAF.replace("bias", "kernel")]).max()
    err = np.abs(ranks[0]["step"]["grads"]["dpn.mlp.4.bias"].numpy() - zero).max()
    assert err / scale < 5e-3, err


@pytest.mark.parametrize("grid", GRIDS)
def test_tap_metric_equal_on_every_rank_and_to_jax(runs, grid):
    want, _, all_ranks = runs
    ranks = all_ranks[grid]
    assert want["oob"] == 0.0 and want["pushed_oob"] > 0.01
    for r in ranks:
        assert r["step"]["losses"]["msda_tap_oob"] == want["oob"]
        assert r["pushed"] == ranks[0]["pushed"]
    assert ranks[0]["pushed"] == pytest.approx(want["pushed_oob"], rel=1e-6)


@pytest.mark.parametrize("grid", GRIDS)
def test_drop_path_masks_equal_on_every_spatial_rank(runs, grid):
    _, _, all_ranks = runs
    data, spatial = grid
    ranks = all_ranks[grid]
    source = DropPathMasks(torch.Generator().manual_seed(get_cfg().SEED))
    draws = [source.draw_global(8 * data, 0.5) for _ in range(3)]
    for rank, r in enumerate(ranks):
        d = rank // spatial
        for i, full in enumerate(draws):
            got = r["masks"][i]
            assert torch.equal(got, full.reshape(2, data, 4)[:, d].reshape(8))
            assert torch.equal(got, ranks[d * spatial]["masks"][i])
