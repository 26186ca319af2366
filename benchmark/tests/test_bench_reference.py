"""The plain float32 reference against the measured package's plain path
at a tiny size on the CPU: the same ``state_dict`` keys and shapes, the
same outputs of a forward, and the same training step (losses, the first
gradient, the parameters after three updates), the swin variant's
drop-path masks included."""

import json

import numpy as np
import pytest
import torch

from benchmark import frames, harness, reference
from benchmark.reference import train as rtrain
from benchmark.tests import tiny

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def spec(config, mode):
    conf = json.loads((tiny.ROOT / "benchmark" / "configs" / f"{config}.json")
                      .read_text())
    out = {}
    for block in ("model", "solver", "precision", mode, "program"):
        out.update(conf.get(block, {}))
    out.update(tiny.TINY_MODEL)
    # the package takes the tanh GELU in bf16 only; in float32 both sides
    # take the exact one
    out.update({"TPU.COMPUTE_DTYPE": "float32", "TPU.GELU_APPROX": False})
    return out


def port_and_reference(config, mode, seed=7):
    from nmrf_tpu_torch.models import build_model

    s = spec(config, mode)
    ref = reference.init_weights(reference.build(s, "cpu"), seed)
    port = build_model(harness.port_cfg(s, seed), device="cpu")
    assert list(port.state_dict()) == list(ref.state_dict())
    for k, v in port.state_dict().items():
        assert v.shape == ref.state_dict()[k].shape, k
    port.load_state_dict(ref.state_dict())
    return s, port, ref


@pytest.mark.parametrize("config", ["nmrf_resnet", "nmrf_swint"])
def test_forward_matches_the_port(config):
    s, port, ref = port_and_reference(config, "serving")
    gen = frames.rng(1, 0)
    a, b, _, _ = frames.stereo_pair(gen, 64, 128, 48)
    x = [torch.from_numpy(f[None].astype(np.float32)) for f in (a, b)]
    with torch.no_grad():
        p, r = port(*x), ref(*x)
    for key in ("disp", "prob", "proposal", "initial_proposal"):
        torch.testing.assert_close(p[key].float(), r[key].float(),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("config", ["nmrf_resnet", "nmrf_swint"])
def test_training_step_matches_the_port(config):
    from nmrf_tpu_torch.models import build_criterion
    from nmrf_tpu_torch.solver import build_optimizer, make_train_step

    s, port, ref = port_and_reference(config, "training")
    cfg = harness.port_cfg(s, 7)
    opt, sched = build_optimizer(port, cfg)
    step = make_train_step(port, build_criterion(cfg), opt, sched,
                           grad_clip=cfg.SOLVER.GRAD_CLIP)
    gen = frames.rng(2, 0)
    batches = []
    for _ in range(3):
        pairs = [frames.stereo_pair(gen, 64, 128, 48) for _ in range(2)]
        a, b, d, v = (torch.from_numpy(np.stack(x)) for x in zip(*pairs))
        batches.append({"img1": a.float(), "img2": b.float(), "disp": d,
                        "valid": v})
    names = {id(p): n for n, p in port.named_parameters()}
    losses, grad = [], None
    for batch in batches:
        losses.append(float(step(batch)["total"]))
        if grad is None:
            grad = {names[id(p)]: st["exp_avg"] / (1 - 0.9)
                    for p, st in opt.state.items()}
    ref.set_drop_path_masks(reference.DropPathMasks(
        torch.Generator().manual_seed(7)))
    r_opt, r_sched = rtrain.optimizer(ref, s)
    out = rtrain.train_steps(ref.set_remat(), rtrain.Criterion(s), r_opt,
                             r_sched, batches, s["SOLVER.GRAD_CLIP"])
    np.testing.assert_allclose(losses, out["loss"], rtol=1e-5)
    for n, g in grad.items():
        torch.testing.assert_close(g, out["grad"][n], rtol=1e-3, atol=1e-7)
    # Adam moves a leaf whose gradient is nought to rounding (a bias under
    # softmax) by up to its learning rate (2e-5 at the first steps) on
    # round-off alone: the parameters agree to a fraction of that
    moved = dict(port.named_parameters())
    for n, p in ref.named_parameters():
        torch.testing.assert_close(moved[n], p, rtol=1e-4, atol=1e-5)
