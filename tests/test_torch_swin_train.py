"""The swin training step of the port against the JAX package (CPU, float32).

The swin config (``configs/sceneflow_swint.yaml``: Swin-T, the deformable
neck with tap radius 5, drop-path 0.4) at 64 x 128, batch 2, 2 layers per
NMP stage, the JAX side on its Pallas path (B5 in interpret mode).  Both
packages take the same weights (``params_from_jax``) and the same keep
masks of drop-path: ``jax.random.bernoulli`` is replaced by seeded numpy
masks handed out in call order, and the port's ``DropPathMasks.draw``
replays them (2 draws per Swin block with a positive rate: 22).  Losses at
rtol 1e-5; every gradient leaf at |d| <= 1e-4 max|g_jax| + 1e-6, as
``tests/test_torch_train.py`` holds the resnet step.

Kinks: at init every sampling displacement is a whole number of level
pixels, where the tap backward's -sign(z) of rounding noise decides d(dx).
So ``sampling_offsets`` is moved off that grid (its bias by 0.3 toward 0
plus noise below 5e-3, its kernel to noise of 1e-5) and the test asserts, on the JAX
side, that no displacement lies within 1e-3 of an integer.  The argmax and
ReLU kinks of the decoder are kept away as in the resnet test, and both
packages must select the same proposal at every pixel.  The neck's
ConvStem (convolution, instance norm, ReLU, then a 3 x 3 max pool) routes
its gradient by the sign of each ReLU input and by each pool window's
largest value, so a ReLU input or a pair of pool candidates within the
packages' f32 difference (about 1e-6) of each other moves its kernels'
gradients past the bound.  The random-dot images hold flat patches whose
equal pixels tie exactly in the pool, so they get a seeded dither of under
one grey level; BATCH_SEED is one at which the stem's ReLU inputs and pool
candidates agree between the packages, and the test asserts that no pool
window of the port's stem holds two values within POOL_MARGIN of its
maximum.
"""

import copy
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from nmrf_tpu.config import get_cfg as get_cfg_jax
from nmrf_tpu.models import build_model as build_model_jax
from nmrf_tpu.utils.checkpoint import convert_torch_state_dict
from nmrf_tpu_torch import (build_criterion, build_model, build_optimizer,
                            get_cfg, make_train_step)
from nmrf_tpu_torch.data import synthetic_batch
from nmrf_tpu_torch.models.adaptor import IMAGENET_MEAN, IMAGENET_STD
from nmrf_tpu_torch.models.layers import DropPath, instance_norm_2d
from nmrf_tpu_torch.utils.convert import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
H, W, B = 64, 128, 2
RADIUS = 5
LOGIT_SCALE = 300.0
HEAD_BIAS = 1.0
BATCH_SEED = 58
MASK_SEED = 3
KINK_MARGIN = 1e-3
RELU_MARGIN = 1e-6
POOL_MARGIN = 5e-6


def swin_cfg(cfg, radius=RADIUS):
    cfg.merge_from_file(str(ROOT / "configs" / "sceneflow_swint.yaml"))
    cfg.NMP.NUM_PROP_LAYERS = 2
    cfg.NMP.NUM_INFER_LAYERS = 2
    cfg.NMP.NUM_REFINE_LAYERS = 2
    cfg.SOLVER.LOSS_WEIGHTS = [1.0, 1.2, 1.4, 2.0]
    cfg.TPU.USE_PALLAS = True
    cfg.TPU.MSDA_TAP_RADIUS = radius
    return cfg


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def swin_params(seed=0):
    """The port's seeded init as a flax tree (the round trip is exact,
    ``tests/test_torch_swin.py``), plus seeded noise on every leaf, the
    decoder's kinks kept away, and ``sampling_offsets`` moved off the
    whole-pixel grid (module docstring)."""
    model = build_model(swin_cfg(get_cfg()), device="cpu")
    tree, unmatched = convert_torch_state_dict(model.state_dict())
    assert unmatched == []
    clean = leaves(tree)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rng.randn(*x.shape).astype(np.float32),
        tree)
    tree = params["params"]
    tree["infer_score_head"]["kernel"] *= LOGIT_SCALE
    for head in (tree["infer_head"], tree["refine_head"],
                 tree["dpn"]["prop_head"]):
        for layer in ("layers_0", "layers_1"):
            head[layer]["bias"] += HEAD_BIAS
    for i in range(4):
        so = tree["backbone"]["neck"][f"extractors_{i}"]["attn"]["sampling_offsets"]
        bias = clean[f"['params']['backbone']['neck']['extractors_{i}']['attn']"
                     "['sampling_offsets']['bias']"]
        toward_zero = np.where(bias > 0, -0.3, 0.3)
        so["bias"] = (bias + toward_zero
                      + rng.uniform(-5e-3, 5e-3, bias.shape)).astype(np.float32)
        so["kernel"] = (1e-5 * rng.randn(*so["kernel"].shape)).astype(np.float32)
    return params


class KeepMasks:
    """Seeded numpy keep masks handed out in call order, to JAX (as
    ``jax.random.bernoulli``) and to the port (as ``DropPathMasks.draw``);
    ``rewind`` before each run so both see the same list."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.masks = []
        self.calls = 0

    def rewind(self):
        self.calls = 0

    def take(self, keep, n):
        if self.calls == len(self.masks):
            self.masks.append((keep, self.rng.rand(n) < keep))
        want_keep, mask = self.masks[self.calls]
        assert keep == pytest.approx(want_keep) and mask.shape == (n,)
        self.calls += 1
        return mask

    def bernoulli(self, key, p, shape):
        return jnp.asarray(self.take(float(p), shape[0]).reshape(shape))

    def draw(self, batch, keep):
        return torch.from_numpy(self.take(keep, batch))


_JAX_STEPS = {}


def _jax_step_fn(radius):
    """The jitted JAX step of the swin config at a tap radius (one compile
    per radius and process; drop-path's draws are traced in as constants,
    so every call replays the masks of the first)."""
    if radius not in _JAX_STEPS:
        cfg = swin_cfg(get_cfg_jax())
        cfg.freeze()
        model, criterion = build_model_jax(cfg, msda_tap_radius=radius)

        def loss_fn(p, b):
            out, mvars = model.apply(
                p, b["img1"], b["img2"], train=True,
                rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["intermediates"],
                capture_intermediates=lambda mdl, _: mdl.name == "sampling_offsets")
            losses = criterion(out, {"disp": b["disp"], "valid": b["valid"]})
            return losses["total"], (losses, out["logits_layers"][-1],
                                     mvars["intermediates"])

        _JAX_STEPS[radius] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return _JAX_STEPS[radius]


def jax_swin_step(params, batch, masks, radius=RADIUS):
    """Losses, gradients, the final proposal logits, the sown
    ``msda_tap_oob`` values and the ``sampling_offsets`` outputs of one JAX
    swin training step, with ``masks`` as drop-path's draws."""
    fn = _jax_step_fn(radius)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    masks.rewind()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", masks.bernoulli)
        (_, (losses, logits, inter)), grads = fn(p, b)
    flat = leaves(inter)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": grads, "logits": np.asarray(logits),
            "oob": max((float(v) for k, v in flat.items() if "msda_tap_oob" in k),
                       default=None),
            "offsets": {k: v for k, v in flat.items() if "sampling_offsets" in k}}


def port_swin_model(params, cfg=None):
    model = build_model(cfg or swin_cfg(get_cfg()), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def replay(model, masks):
    """Let the port's drop-path draw ``masks`` from their start."""
    masks.rewind()
    model.drop_path_masks.draw = masks.draw


def final_logits(model):
    """A list that a forward of ``model`` fills with its final proposal
    logits as [B, H, W, N] (the JAX ``logits_layers[-1]`` layout), and the
    hook's handle."""
    seen = []

    def hook(_module, _inputs, out):
        lg = out[-1].detach()  # [B, h8, w8, N, 64]
        b, h8, w8, n, _ = lg.shape
        lg = lg.reshape(b, h8, w8, n, 8, 8).permute(0, 1, 4, 2, 5, 3)
        seen.append(lg.reshape(b, h8 * 8, w8 * 8, n).numpy())

    return seen, model.infer_score_head.register_forward_hook(hook)


def port_grads(model, batch, masks):
    """Losses, gradients (as a flax tree) and final proposal logits of one
    port forward and backward in train mode, drop-path drawing ``masks``."""
    model.zero_grad(set_to_none=True)
    model.train()
    replay(model, masks)
    seen, handle = final_logits(model)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    try:
        out = model(tb["img1"], tb["img2"])
    finally:
        handle.remove()
    losses = build_criterion(swin_cfg(get_cfg()))(out, tb)
    losses["total"].backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return ({k: float(v.detach()) for k, v in losses.items()},
            convert_torch_state_dict(grads)[0], seen[-1])


def assert_step_matches(port, want):
    """One port step ``port_grads(...)`` against one JAX step: every loss at
    rtol 1e-5, every gradient leaf at |d| <= 1e-4 max|g_jax| + 1e-6, after
    checking that the two select the same proposal at every pixel (an
    argmax near-tie may flip between the packages' f32 roundings)."""
    got_losses, got_grads, logits = port
    np.testing.assert_array_equal(logits.argmax(-1), want["logits"].argmax(-1))
    assert set(got_losses) == set(want["losses"])
    for key, value in want["losses"].items():
        np.testing.assert_allclose(got_losses[key], value, rtol=1e-5, err_msg=key)
    w, g = leaves(want["grads"]), leaves(got_grads)
    assert w.keys() == g.keys()
    bad = []
    for key, ref in w.items():
        bound = 1e-4 * np.abs(ref).max() + 1e-6
        err = np.abs(g[key] - ref).max()
        if err > bound:
            bad.append(f"{key}: |d| {err:.3e} > {bound:.3e} (max {np.abs(ref).max():.3e})")
    assert not bad, "\n".join(bad)


def displacements(offsets):
    """Every extractor's sample displacements from its query's base cell, in
    level pixels: {f: (dx, dy)} from the captured ``sampling_offsets``
    outputs [2B, Hq*Wq, M*P*2] (one level each, factor 2**i)."""
    Hq, Wq = H // 4, W // 4
    out = {}
    for key, off in offsets.items():
        i = int(key.split("extractors_")[1][0])
        f = 2 ** i
        off = off.reshape(off.shape[0], Hq, Wq, -1, 2).astype(np.float64)
        qy, qx = np.arange(Hq), np.arange(Wq)
        cy = (qy + 0.5) / f - 0.5 - ((2 * qy + 1 + f) // (2 * f) - 1)
        cx = (qx + 0.5) / f - 0.5 - ((2 * qx + 1 + f) // (2 * f) - 1)
        out[f] = (off[..., 0] + cx[None, None, :, None],
                  off[..., 1] + cy[None, :, None, None])
    return out


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for the port's steps here: the suite runs a test
    process per core or so, and at torch's default pool width per process
    these steps ran several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return swin_params()


def dithered_batch(seed):
    """synthetic_batch with a seeded dither of under one grey level on both
    images (module docstring)."""
    batch = synthetic_batch(B, H, W, max_disp=48, seed=seed)
    rng = np.random.RandomState(seed)
    for key in ("img1", "img2"):
        batch[key] = batch[key] + rng.rand(*batch[key].shape).astype(np.float32)
    return batch


def stem_margins(model, batch):
    """(the smallest |ReLU input|, the smallest gap between the largest and
    the second value of a 3 x 3 max-pool window with a positive maximum) of
    the port's ConvStem on the batch (its layers, the pooling recomputed)."""
    image = torch.cat([torch.from_numpy(batch["img1"]),
                       torch.from_numpy(batch["img2"])])
    x = (image - torch.from_numpy(IMAGENET_MEAN)) / torch.from_numpy(IMAGENET_STD)
    relu_in = []
    with torch.no_grad():
        for conv in model.backbone.neck.stem.stem.values():
            y = instance_norm_2d(conv(x))
            relu_in.append(float(y.abs().min()))
            x = torch.relu(y)
    x = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), value=float("-inf"))
    windows = x.unfold(2, 3, 2).unfold(3, 3, 2).reshape(*x.shape[:2], -1, 9)
    top2 = windows.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1])[top2[..., 0] > 0]
    return min(relu_in), float(gap.min())


@pytest.fixture(scope="module")
def batch():
    return dithered_batch(BATCH_SEED)


@pytest.fixture(scope="module")
def masks():
    return KeepMasks(MASK_SEED)


@pytest.fixture(scope="module")
def jax_result(params, batch, masks):
    return jax_swin_step(params, batch, masks)


def push_offsets(params, shift):
    """A copy of params with every ``sampling_offsets`` bias moved ``shift``
    level pixels away from zero: whole pixels, so the fractional parts and
    the kink margins stay."""
    out = copy.deepcopy(params)
    for i in range(4):
        so = out["params"]["backbone"]["neck"][f"extractors_{i}"]["attn"]["sampling_offsets"]
        so["bias"] = so["bias"] + np.where(so["bias"] >= 0, shift, -shift).astype(np.float32)
    return out


def port_step(model, cfg, masks, monitor_oob=True):
    """make_train_step of ``model`` at lr 0 (the weights stay), drop-path
    drawing ``masks``."""
    cfg.SOLVER.BASE_LR = 0.0
    optimizer, scheduler = build_optimizer(model, cfg)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           grad_clip=cfg.SOLVER.GRAD_CLIP, monitor_oob=monitor_oob)

    def run(batch):
        replay(model, masks)
        return step({k: torch.from_numpy(v) for k, v in batch.items()})

    run.read_oob = step.read_oob
    return run


def test_swin_train_step_matches_jax(params, batch, masks, jax_result):
    # the drop-path draws: 2 a block with a positive rate, some dropping
    model = port_swin_model(params)
    rates = [m.rate for m in model.backbone.backbone.modules()
             if isinstance(m, DropPath)]
    assert rates[0] == 0.0 and rates[-1] == pytest.approx(0.4)
    n_draws = 2 * sum(r > 0 for r in rates)
    assert n_draws == 22 and masks.calls == n_draws
    drawn = np.stack([m for _, m in masks.masks])
    assert drawn.any() and not drawn.all()
    # no displacement near a hat kink, every sample within the radius
    for f, (dx, dy) in displacements(jax_result["offsets"]).items():
        for d in (dx, dy):
            assert np.abs(d).max() < RADIUS, f
            assert np.abs(d - np.round(d)).min() > KINK_MARGIN, f
    assert len(jax_result["offsets"]) == 4 and jax_result["oob"] == 0.0

    relu_margin, pool_gap = stem_margins(model, batch)
    assert relu_margin > RELU_MARGIN and pool_gap > POOL_MARGIN
    port = port_grads(model, batch, masks)
    assert masks.calls == n_draws
    assert_step_matches(port, jax_result)


def test_drop_path_masks_matter(params, batch, jax_result):
    """The same forward with the model's own seeded masks instead of the
    replayed ones moves the loss: the match above rests on the masks."""
    model = port_swin_model(params).train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        total = build_criterion(swin_cfg(get_cfg()))(
            model(tb["img1"], tb["img2"]), tb)["total"]
    assert float(total) != pytest.approx(jax_result["losses"]["total"], rel=1e-5)


def test_oob_metric_matches_jax(params, batch, masks, jax_result):
    """``msda_tap_oob`` of ``make_train_step(..., monitor_oob=True)`` equals
    the JAX step's sown metric: 0 at these weights (every sample within the
    radius), and the same share once the offsets are pushed 3 level pixels
    out, where part of the samples leave it."""
    pushed = push_offsets(params, 3.0)
    for p, want in ((params, jax_result["oob"]),
                    (pushed, jax_swin_step(pushed, batch, masks)["oob"])):
        model = port_swin_model(p)
        got = port_step(model, swin_cfg(get_cfg()), masks)(batch)["msda_tap_oob"]
        assert float(got) == want
    assert 1e-3 < want < 1.0
