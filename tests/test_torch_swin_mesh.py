"""The swin training step on a data-parallel mesh (CPU, float32, gloo).

Two processes on a 2 x 1 (data, spatial) grid take the swin test step of
``tests/test_torch_swin_train.py`` (64 x 128, batch 2: one pair a rank, 2
layers per NMP stage, the same weights, batch and drop-path masks) through
``make_train_step(..., mesh=, monitor_oob=True)``; the process body is
``swin_mesh_worker`` in ``tests/test_torch_spatial_workers.py``.

* The step equals the JAX global step (one jit over the whole batch):
  losses at rtol 1e-5, every gradient leaf within 1e-4 max|g_jax| + 1e-6,
  as ``tests/test_torch_swin_train.py`` holds the single-device step.  The
  JAX step draws drop-path's masks over the global backbone batch [img1 of
  both pairs; img2 of both pairs]; the ranks replay those global masks
  through ``DropPathMasks.draw_global`` and keep their own rows.
* The model's own ``DropPathMasks`` on the two ranks give their rows of
  one global draw of the seeded generator.
* With rank 1's samples moved beyond the tap radius (rank 0's stay
  within), ``msda_tap_oob`` is the same on both ranks and equals the JAX
  global step's sown metric with pair 1's sampling locations moved the
  same way (each extractor's share over the whole batch, then the
  maximum); each extractor's share is the mean of the ranks' shares, and
  a fallback guard trips on both, which then take the exact path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmrf_tpu.models.adaptor as jax_adaptor
import nmrf_tpu.ops.msda as jax_msda
from nmrf_tpu.config import get_cfg as get_cfg_jax
from nmrf_tpu.models import build_model as build_model_jax
from nmrf_tpu.parallel.mesh import _max_oob
from nmrf_tpu.utils.checkpoint import convert_torch_state_dict
from nmrf_tpu_torch import get_cfg
from nmrf_tpu_torch.models.layers import DropPathMasks
from nmrf_tpu_torch.parallel import spawn
from nmrf_tpu_torch.utils.convert import params_from_jax

from . import test_torch_spatial_workers as W
from .test_torch_swin_train import (BATCH_SEED, MASK_SEED, RADIUS,  # noqa: F401
                                    KeepMasks, assert_step_matches,
                                    dithered_batch, few_threads,
                                    jax_swin_step, swin_cfg, swin_params)

WORLD = 2
PUSH = 8.0  # level pixels to the right: swin_mesh_worker's push of rank 1


def jax_pushed_oob(params, batch, masks, pair=1):
    """The sown ``msda_tap_oob`` of the JAX global step's forward (the
    maximum over extractors of each one's share over the whole batch,
    ``nmrf_tpu/parallel/mesh.py:_max_oob``) with pair ``pair``'s sampling
    locations moved PUSH level pixels right, in the metric and in the
    sampling alike: rows ``pair`` and B + ``pair`` of the backbone batch
    [img1; img2], the rows rank ``pair`` holds."""
    cfg = swin_cfg(get_cfg_jax())
    cfg.freeze()
    model, _ = build_model_jax(cfg, msda_tap_radius=RADIUS)
    B = batch["img1"].shape[0]
    rows = np.zeros((2 * B, 1, 1, 1, 1), np.float32)
    rows[[pair, B + pair]] = 1.0
    fraction, taps = jax_msda.tap_out_of_range_fraction, jax_adaptor.ms_deform_attn_taps

    def push(locations, spatial_shapes):
        width = jnp.asarray([float(w) for _, w in spatial_shapes], jnp.float32)
        shift = jnp.where(rows > 0, (PUSH / width)[:, None], 0.0)  # [2B, 1, 1, L, 1]
        return locations + jnp.stack([shift, jnp.zeros_like(shift)], -1)

    def pushed_fraction(locations, spatial_shapes, *args):
        return fraction(push(locations, spatial_shapes), spatial_shapes, *args)

    def pushed_taps(value, spatial_shapes, locations, *args):
        return taps(value, spatial_shapes, push(locations, spatial_shapes), *args)

    def forward(p, b):
        _, mvars = model.apply(p, b["img1"], b["img2"], train=True,
                               rngs={"dropout": jax.random.PRNGKey(0)},
                               mutable=["intermediates"])
        return _max_oob(mvars)

    masks.rewind()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", masks.bernoulli)
        mp.setattr(jax_msda, "tap_out_of_range_fraction", pushed_fraction)
        mp.setattr(jax_adaptor, "ms_deform_attn_taps", pushed_taps)
        oob = jax.jit(forward)(jax.tree_util.tree_map(jnp.asarray, params),
                               {k: jnp.asarray(v) for k, v in batch.items()})
    return float(oob)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX global step and the two ranks' results."""
    params, batch, masks = swin_params(), dithered_batch(BATCH_SEED), KeepMasks(MASK_SEED)
    want = jax_swin_step(params, batch, masks)
    want["pushed_oob"] = jax_pushed_oob(params, batch, masks)
    tmp = tmp_path_factory.mktemp("swin_mesh")
    torch.save(params_from_jax(params), tmp / "weights.pt")
    np.savez(tmp / "batch.npz", **batch)
    torch.save([(keep, torch.from_numpy(m)) for keep, m in masks.masks],
               tmp / "masks.pt")
    spawn(W.swin_mesh_worker, WORLD, "gloo", args=(str(tmp), str(tmp)),
          timeout_s=300)
    ranks = [torch.load(tmp / f"swin_mesh_{r}.pt") for r in range(WORLD)]
    return want, masks, ranks


def _logits(lg):
    """[b, h8, w8, N, 64] subpatch logits -> [b, H, W, N]."""
    b, h8, w8, n, _ = lg.shape
    lg = lg.reshape(b, h8, w8, n, 8, 8).permute(0, 1, 4, 2, 5, 3)
    return lg.reshape(b, h8 * 8, w8 * 8, n).numpy()


def test_worker_cfg_is_the_swin_test_cfg():
    assert W.swin_small_cfg(get_cfg()).dump() == swin_cfg(get_cfg()).dump()


def test_data_parallel_swin_step_matches_jax_global_step(runs):
    want, masks, ranks = runs
    # every rank replayed each of the JAX step's global draws once
    assert all(r["draws"] == len(masks.masks) == 22 for r in ranks)
    assert all(m.shape == (4,) for _, m in masks.masks)
    for r in ranks:
        assert r["step"]["losses"]["msda_tap_oob"] == want["oob"] == 0.0
    losses = {k: v for k, v in ranks[0]["step"]["losses"].items()
              if k in want["losses"]}
    for r in ranks[1:]:
        assert r["step"]["losses"] == ranks[0]["step"]["losses"]
        for k, g in r["step"]["grads"].items():
            assert torch.equal(g, ranks[0]["step"]["grads"][k]), k
    grads = convert_torch_state_dict(ranks[0]["step"]["grads"])[0]
    logits = np.concatenate([_logits(r["step"]["logits"]) for r in ranks])
    assert_step_matches((losses, grads, logits), want)


def test_drop_path_masks_are_rows_of_one_global_draw(runs):
    """Rank r's mask of a backbone batch of 8 ([img1; img2] of its 4
    pairs) is its 4 rows of each half of the global draw of 16 ([img1 of
    all 8 pairs; img2 of all 8 pairs]) from the generator every rank seeds
    alike, not 8 rows in a run."""
    _, _, ranks = runs
    source = DropPathMasks(torch.Generator().manual_seed(get_cfg().SEED))
    draws = [source.draw_global(8 * WORLD, 0.5) for _ in range(3)]
    for rank, r in enumerate(ranks):
        for got, full in zip(r["masks"], draws):
            assert torch.equal(got, full.reshape(2, WORLD, 4)[:, rank].reshape(8))
        assert any(not torch.equal(got, full[8 * rank:8 * (rank + 1)])
                   for got, full in zip(r["masks"], draws))


def test_oob_metric_and_guard_agree_across_ranks(runs):
    want_jax, _, ranks = runs
    pushed = [r["pushed"] for r in ranks]
    local = [torch.stack(p["local"]) for p in pushed]  # [extractors, levels]
    assert float(local[0].max()) == 0.0 and float(local[1].max()) > 0.1
    want = float(sum(local).div(WORLD).max())
    assert pushed[0]["oob"] == pushed[1]["oob"]
    assert pushed[0]["oob"] == pytest.approx(want_jax["pushed_oob"], rel=1e-6)
    assert pushed[0]["oob"] == pytest.approx(want, rel=1e-6)
    # the JAX order differs from the maximum of the ranks' own shares
    assert want_jax["pushed_oob"] < float(local[1].max())
    for p in pushed:
        assert p["read"] == p["oob"] and p["fired"]
        assert p["radii"] == [0, 0, 0, 0]
