"""The port's checkpoints against the JAX package and against a run that
never stopped (CPU).

* a saved training state comes back bit for bit, its tensors on the CPU;
* ``prune_stale_latest`` keeps the names the JAX one keeps;
* the Swin-T converter and ``load_pretrained_swin`` give, on a torch
  Swin-T ``state_dict`` the test builds, the tensors that the JAX
  ``convert_swin_state_dict`` and ``load_pretrained_swin`` merge into the
  JAX tree (carried back by ``params_from_jax``), exactly;
* ``load_torch_checkpoint`` reads an upstream ``.pth`` (``image_encoder.``
  names, buffers that hold no weight) and reports missing and unexpected
  keys;
* exact resume, on the swin config with drop-path 0.4 and ``ACCUM_STEPS``
  2: four updates straight equal two updates, a save, a fresh process's
  restore and two more (losses, weights and AdamW state bit for bit, both
  runs under ``utils.misc.deterministic``); so does a save between
  micro-steps; and a resume with a larger ``MAX_ITER`` follows the rates of
  a run of the new ``MAX_ITER`` from step 0 bit for bit, and the JAX
  schedule of the new ``MAX_ITER`` (float32) to 1e-6.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nmrf_tpu.config import get_cfg as get_cfg_jax
from nmrf_tpu.solver import build_optimizer as build_optimizer_jax
from nmrf_tpu.utils import checkpoint as CJ
from nmrf_tpu_torch import (build_criterion, build_model, build_optimizer,
                            get_cfg, make_train_step)
from nmrf_tpu_torch.solver import build_scheduler
from nmrf_tpu_torch.utils import checkpoint as C
from nmrf_tpu_torch.utils.convert import params_from_jax
from nmrf_tpu_torch.utils.misc import deterministic
from tests.test_torch_spatial_workers import (RESUME_MICRO_STEPS, resume_batch,
                                              resume_cfg, swin_small_cfg)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads (the suite runs a test process per core or so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _equal(a, b, path="state"):
    """Nested dicts, lists and tensors equal bit for bit."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def _small_resnet():
    cfg = get_cfg()
    cfg.NMP.NUM_PROP_LAYERS = 1
    cfg.NMP.NUM_INFER_LAYERS = 2
    cfg.NMP.NUM_REFINE_LAYERS = 2
    cfg.SOLVER.LOSS_WEIGHTS = [1.0, 1.2, 1.4, 2.0]
    cfg.DPN.MAX_DISP = 64
    cfg.SOLVER.MAX_DISP = 48
    cfg.freeze()
    return cfg


def test_round_trip_is_exact_and_prune_matches_jax(tmp_path):
    cfg = _small_resnet()
    model = build_model(cfg, device="cpu")
    optimizer, scheduler = build_optimizer(model, cfg)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           grad_clip=1.0)
    step({k: v[:, :32, :64] for k, v in resume_batch(1).items()})
    state = C.train_state(model, optimizer, 7, step)
    path = C.save_checkpoint(str(tmp_path), 7, state)
    assert sorted(os.listdir(tmp_path)) == ["latest.txt", "step_00000007"]
    assert os.listdir(path) == [C.STATE_FILE]
    back, step_no = C.restore_checkpoint(str(tmp_path))
    assert step_no == 7
    _equal(C._to_cpu(state), back)
    assert all(t.device.type == "cpu" for t in back["model"].values())

    for root in (tmp_path / "port", tmp_path / "jax"):
        for s in (2, 4, 100, 200, 204):
            (root / f"step_{s:08d}").mkdir(parents=True)
        (root / "latest.txt").write_text("204")
        (root / "not_a_step").mkdir()
    C.prune_stale_latest(str(tmp_path / "port"), 204, 100)
    CJ.prune_stale_latest(str(tmp_path / "jax"), 204, 100)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax")) == [
            "latest.txt", "not_a_step", "step_00000100", "step_00000200",
            "step_00000204"]


def test_swin_converter_and_loader_match_jax(tmp_path):
    model = build_model(swin_small_cfg(get_cfg()), device="cpu")
    rng = np.random.RandomState(0)
    sd = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
          for k, v in model.backbone.backbone.state_dict().items()}
    # what the reference's checkpoint filter drops
    sd["layers.0.blocks.1.attn_mask"] = torch.zeros(4, 49, 49)
    sd["layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(49, 49)
    sd["norm.weight"] = torch.ones(768)
    sd["head.weight"] = torch.zeros(1000, 768)
    path = str(tmp_path / "swin_tiny.pth")
    torch.save({"model": sd}, path)

    tree, unmatched = CJ.convert_torch_state_dict(model.state_dict())
    assert unmatched == []
    merged = params_from_jax(CJ.load_pretrained_swin(tree, path))
    C.load_pretrained_swin(model, path)
    got = model.state_dict()
    assert got.keys() == merged.keys()
    for key in got:
        assert torch.equal(got[key], merged[key]), key

    bad = dict(sd, **{"layers.0.blocks.0.attn.extra": torch.zeros(1)})
    assert C.convert_swin_state_dict(bad)[1] == CJ.convert_swin_state_dict(
        {k: v.numpy() for k, v in bad.items()})[1] == ["layers.0.blocks.0.attn.extra"]
    torch.save(bad, path)
    with pytest.raises(ValueError, match="unmatched"):
        C.load_pretrained_swin(model, path)


def test_load_torch_checkpoint_reports_unmatched(tmp_path):
    cfg = _small_resnet()
    source = build_model(cfg, device="cpu")
    upstream = {("image_encoder." + k[len("backbone."):]
                 if k.startswith("backbone.") else k): v
                for k, v in source.state_dict().items()}
    upstream["backbone_buffer.num_batches_tracked"] = torch.zeros(())
    upstream["device_indicator_tensor"] = torch.zeros(0)
    torch.save({"model": upstream, "iteration": 5}, tmp_path / "a.pth")
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    assert C.load_torch_checkpoint(model, str(tmp_path / "a.pth")) == []
    _equal(source.state_dict(), model.state_dict())

    bare = dict(source.state_dict())
    bare.pop("infer_score_head.bias")
    bare["extra.weight"] = torch.zeros(3)
    torch.save(bare, tmp_path / "b.pth")
    assert C.load_torch_checkpoint(model, str(tmp_path / "b.pth")) == [
        "infer_score_head.bias", "extra.weight"]


# the fresh schedule below steps with no optimizer step, which torch warns of
@pytest.mark.filterwarnings("ignore:Detected call of")
def test_exact_resume_with_drop_path_and_accumulation(tmp_path):
    cfg = resume_cfg()
    model = build_model(cfg, device="cpu")
    optimizer, scheduler = build_optimizer(model, cfg)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg.SOLVER.ACCUM_STEPS, grad_clip=cfg.SOLVER.GRAD_CLIP)
    losses = []
    # deterministic on both sides: on the CPU, with more than one thread,
    # the accumulating index of the window tables' gradient adds in another
    # order from run to run otherwise
    with deterministic():
        for s in range(1, RESUME_MICRO_STEPS + 1):
            losses.append(float(step(resume_batch(s))["total"]))
            if s in (3, 4):  # between micro-steps, after the second update
                C.save_checkpoint(str(tmp_path), s,
                                  C.train_state(model, optimizer, s, step))
    assert C.restore_checkpoint(str(tmp_path), 3)[0]["train_step"]["micro"] == 1
    out = str(tmp_path / "resumed.pt")
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_spatial_workers import resume_worker; "
            "resume_worker(sys.argv[2], json.loads(sys.argv[3]), sys.argv[4])")
    r = subprocess.run([sys.executable, "-c", code, str(ROOT), str(tmp_path),
                        json.dumps([4, 3]), out], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    resumed = torch.load(out, weights_only=True)
    for start in (4, 3):
        assert resumed[start]["losses"] == losses[start:], start
        _equal(model.state_dict(), resumed[start]["model"], f"model from {start}")
        _equal(optimizer.state_dict()["state"], resumed[start]["optimizer"],
               f"AdamW from {start}")

    # a larger MAX_ITER: the JAX schedule of the new horizon, from the
    # saved number of updates on
    longer = resume_cfg(max_iter=400)
    model = build_model(longer, device="cpu")
    optimizer, _ = build_optimizer(model, longer)
    state, start = C.restore_checkpoint(str(tmp_path), 4)
    C.load_train_state(state, model, optimizer)
    scheduler = build_scheduler(optimizer, longer, start // 2)
    cfg_jax = swin_small_cfg(get_cfg_jax())
    cfg_jax.SOLVER.MAX_ITER = 400
    cfg_jax.freeze()
    tree, _ = CJ.convert_torch_state_dict(model.state_dict())
    _, schedule = build_optimizer_jax(tree, cfg_jax)
    fresh_model = build_model(longer, device="cpu")
    fresh, fresh_scheduler = build_optimizer(fresh_model, longer)
    for _ in range(start // 2):
        fresh_scheduler.step()
    for update in range(start // 2, start // 2 + 30):
        got = [g["lr"] for g in optimizer.param_groups]
        # the rates of a run of the new MAX_ITER from step 0, bit for bit
        assert got == [g["lr"] for g in fresh.param_groups], update
        # the JAX schedule is float32 (its warm-up cancels to about 1e-6
        # relative): the tolerance of test_schedule_and_groups_match_jax
        np.testing.assert_allclose(got[0], float(schedule(update)), rtol=1e-6,
                                   atol=1e-10, err_msg=str(update))
        scheduler.step()
        fresh_scheduler.step()
